"""Event data: file readers and the on-device voxelization of the wire."""
