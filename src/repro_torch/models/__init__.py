"""The decoder LM of the port: layers, attention and the model."""
