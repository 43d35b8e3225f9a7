"""Carry a cluster model between the JAX package and the port as numpy.

``model_to_numpy`` gives ``(fields, static)``: every tensor leaf of a
``TensorClusterModel`` as a numpy array under its field name, and the static
ints.  ``model_from_numpy`` rebuilds the model on ``device``.  The JAX
package's model has the same field names and static ints, so the same
dicts, read from its leaves with ``np.asarray``, carry a model across in
either direction.  This module imports no JAX: the caller does the reading.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.tensor_model import (STATIC_FIELDS, TENSOR_FIELDS,
                                                         TensorClusterModel)


def model_from_numpy(fields: Dict[str, np.ndarray], static: Dict[str, int],
                     device: Union[str, torch.device] = "cuda") -> TensorClusterModel:
    """Model on ``device`` from numpy leaves and static ints (types are kept:
    int32 ids, bool masks, float32 loads, int8 broker states)."""
    dev = resolve_device(device)
    missing = [f for f in TENSOR_FIELDS if f not in fields] + \
        [s for s in STATIC_FIELDS if s not in static]
    if missing:
        raise KeyError(f"missing model fields: {missing}")
    tensors = {f: torch.from_numpy(np.array(fields[f], copy=True)).to(dev)
               for f in TENSOR_FIELDS}
    return TensorClusterModel(**tensors, **{s: int(static[s]) for s in STATIC_FIELDS})


def model_to_numpy(model: TensorClusterModel) -> Tuple[Dict[str, np.ndarray],
                                                       Dict[str, int]]:
    """(fields, static) of ``model``: host numpy copies and static ints."""
    fields = {f: getattr(model, f).detach().cpu().numpy() for f in TENSOR_FIELDS}
    static = {s: int(getattr(model, s)) for s in STATIC_FIELDS}
    return fields, static
