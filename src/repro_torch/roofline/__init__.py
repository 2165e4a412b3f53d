"""Per-device statistics of a step and its H100 roofline."""
