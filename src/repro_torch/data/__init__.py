"""Host-side data plane (numpy, no device): the paper's calibrated corpus
and its n-gram event streams, the recsys event streams, and the
stateless, prefetching batch pipeline."""
