"""Ensemble moves: the stretch move and the tempering ladder."""
