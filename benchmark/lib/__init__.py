"""The harness: cell resolution, spans, the device trace, the roofline yardstick."""
