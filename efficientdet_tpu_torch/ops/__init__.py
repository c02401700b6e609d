"""Tensor ops of the PyTorch port: padding, anchors, boxes, losses, NMS."""
