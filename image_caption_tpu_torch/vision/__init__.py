"""Region-feature extraction: YOLOv5 detection, crops, ResNet-101 features."""
