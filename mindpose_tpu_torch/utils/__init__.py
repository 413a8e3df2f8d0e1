"""Host utilities of the port: checkpoints, the COCO keypoint metric and its native library."""
