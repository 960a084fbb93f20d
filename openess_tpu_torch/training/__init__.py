"""Model construction (the serving subset so far)."""
