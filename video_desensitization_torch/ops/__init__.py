"""Closed-form tensor ops: anchors, boxes, NMS, image preprocessing, mosaic."""
