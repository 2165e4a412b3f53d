"""Registered configurations of the port: the paper's sketch variants
(`paper_sketch`) and the shape tables of the model families."""
