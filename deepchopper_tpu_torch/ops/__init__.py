"""Host-side sequence/quality/label ops and the device kernels' wrappers."""
