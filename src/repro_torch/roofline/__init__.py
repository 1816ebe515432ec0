"""Roofline analysis of the port's steps, counted op by op on any device
(the meta device included): the torch counterpart of ``repro.roofline``."""

from .analysis import HW, RooflineCell, analyze  # noqa: F401
from .op_cost import OpCost, charge_kernel, count  # noqa: F401
