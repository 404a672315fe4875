"""Percent of the device's busy time in the window spent in operations on
complex values, by ``spectral_share.fno``'s rule, read by that file's
reader (the union of the intervals of the kernels whose names mark them
complex over the union of all): in FNO-3d's step the spectral
convolutions' transforms over the residue axes, their mixing and their
complex casts and copies. The DFT form's time transforms are real
products and are not in it."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("spectral_share.fno.py")
_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.spectral_share.fno", _path)
_fno = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fno)


def read(run):
    return _fno.read(run)
