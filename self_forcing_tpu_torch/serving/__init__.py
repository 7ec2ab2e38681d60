"""Serving of the PyTorch package: the WebSocket transport and the
streaming demo app."""
