"""Host-side data for the port: synthetic sequences and a synthetic
populated map, the reference's YAML settings and the dataset loaders."""
