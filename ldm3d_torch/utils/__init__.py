"""utils of the PyTorch port."""
