"""General traffic drivers, one per kind of traffic file (its \"driver\" key)."""
