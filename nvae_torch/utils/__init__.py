"""Helpers of the port: seeds, PNG images, metrics logging."""
