"""Utilities: roofline audits, collective audits."""
from .roofline import (CHIPS, ChipSpec, RooflineReport, audit, chip_spec,
                       marginal_time, matmul_unit)
