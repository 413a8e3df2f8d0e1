"""Host utilities of the port: checkpoints and the COCO keypoint metric."""
