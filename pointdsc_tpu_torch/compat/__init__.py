"""Checkpoint readers and the weight bridge into the port's state dict."""
