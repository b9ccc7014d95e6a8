"""LISA layer: sensitivity curves, noise, inner products and the
whitened likelihood."""
