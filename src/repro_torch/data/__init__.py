"""Host-side data plane of the paper's workload: the calibrated corpus
and its n-gram event streams (numpy, no device)."""
