"""
Variable types and option-type encoding.

PyTorch counterpart of ``stochvolmodels_tpu/config.py``.  Unlike the JAX
package, importing this module changes no global state: there is no x64 flag
to flip (every tensor here carries an explicit dtype) and no compile cache.
"""
from __future__ import annotations

from enum import Enum

import numpy as np


class VariableType(Enum):
    """transform variable: log-return, quadratic variance, or instantaneous vol."""
    LOG_RETURN = 1
    Q_VAR = 2
    SIGMA = 3
    POINT_VALUE = 4


class OptionType(str, Enum):
    """'C'/'P' vanilla, 'IC'/'IP' inverse (payoff divided by terminal spot)."""
    CALL = 'C'
    PUT = 'P'
    INVERSE_CALL = 'IC'
    INVERSE_PUT = 'IP'


# int codes used inside tensor code: bit0 = is_call, bit1 = is_inverse
OPTION_CODES = {'P': 0, 'C': 1, 'IP': 2, 'IC': 3}
OPTION_CODES_INV = {v: k for k, v in OPTION_CODES.items()}


def encode_optiontypes(optiontypes: np.ndarray) -> np.ndarray:
    """map string option types to int8 codes."""
    return np.asarray([OPTION_CODES[str(t)] for t in np.asarray(optiontypes).ravel()],
                      dtype=np.int8).reshape(np.asarray(optiontypes).shape)


def decode_optiontypes(codes: np.ndarray) -> np.ndarray:
    """inverse of :func:`encode_optiontypes`."""
    return np.asarray([OPTION_CODES_INV[int(c)] for c in np.asarray(codes).ravel()],
                      dtype='<U2').reshape(np.asarray(codes).shape)
