"""Sparse-matrix format data models + encode/decode codecs.

Device re-design of the reference's format structs
(``MMRawData``/``CSRData``/``TJDSData``/``TXTable``, main-cli.c:42-83):
immutable pytree dataclasses with static padded shapes, encoded and decoded
by jitted XLA programs instead of qsort + pointer loops.
"""

from smvp_toolkit_tpu.formats.coo import COOMatrix
from smvp_toolkit_tpu.formats.csr import CSRMatrix, csr_encode, csr_decode
from smvp_toolkit_tpu.formats.tjds import TJDSMatrix, tjds_encode, tjds_decode
from smvp_toolkit_tpu.formats.cisr import CISRMatrix, cisr_encode, cisr_decode

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "csr_encode",
    "csr_decode",
    "TJDSMatrix",
    "tjds_encode",
    "tjds_decode",
    "CISRMatrix",
    "cisr_encode",
    "cisr_decode",
]
