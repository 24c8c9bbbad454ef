"""The training data pipeline: DTU-format files, augmentation, datasets and
the loader (numpy, zlib and the standard library; no PIL, no OpenCV)."""
