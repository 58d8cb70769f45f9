"""Host utilities of the PyTorch port: visual dumps and step profiling."""
