"""Model scaffold of the port: parameter specs (`params`), shared layers
(`layers`) and the recommender family's DLRM and two-tower halves
(`recsys`), the sketch-gated path of the counting system."""
