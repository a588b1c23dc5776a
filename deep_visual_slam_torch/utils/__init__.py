"""Config, weight transfer and the CUDA build."""
