"""Applications explored by the COSMOS engine."""
