"""Host-side I/O: KITTI sequences, PNG decoding, trajectories."""
