"""Host-side data for the port: synthetic sequences, the reference's YAML
settings and the dataset loaders."""
