"""Roofline accounting for the port: the H100 device table and terms
(`analysis`) and the op-level FLOP/byte counter (`op_cost`)."""
from repro_torch.roofline.analysis import RooflineTerms, analyze  # noqa: F401
