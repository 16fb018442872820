"""The port's models: the Llama family and its paged-attention decode."""
