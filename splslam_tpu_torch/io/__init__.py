"""Host-side data for the port: synthetic sequences."""
