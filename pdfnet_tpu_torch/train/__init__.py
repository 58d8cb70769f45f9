"""Loss, eval outputs, and the train and eval steps of the PyTorch port."""
