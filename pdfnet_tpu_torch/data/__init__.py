"""Host-side (numpy) data of the PyTorch port: CenterNet targets, point-cloud
sampling and synthetic batches."""
