"""The benchmark of the PyTorch port on the card; see README.md."""
