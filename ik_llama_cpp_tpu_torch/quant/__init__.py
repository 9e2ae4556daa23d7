"""Quant codec layer. Importing registers the codebook i-quants into the
dequant dispatch table."""
from .dequant import DEQUANT_FNS
from .iquants import IQUANT_FNS

DEQUANT_FNS.update(IQUANT_FNS)
