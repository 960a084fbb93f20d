"""Event data: file readers, the synthetic dataset, augmentation and the
on-device voxelization of the wire."""
