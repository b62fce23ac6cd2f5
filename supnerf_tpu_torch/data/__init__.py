"""Dataset-side code of the port: the synthetic fixture."""
