"""Entry-point drivers of the port."""
