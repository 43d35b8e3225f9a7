"""Carry a cluster model between the JAX package and the port as numpy.

``model_to_numpy`` gives ``(fields, static)``: every tensor leaf of a
``TensorClusterModel`` as a numpy array under its field name, and the static
ints.  ``model_from_numpy`` rebuilds the model on ``device``.  The JAX
package's model has the same field names and static ints, so the same
dicts, read from its leaves with ``np.asarray``, carry a model across in
either direction; a JAX model whose replica axis is sharded over a device
mesh reads whole (``np.asarray`` of a sharded array gathers it), so it
converts to the same port model as the unsharded one.  ``aggregation_to_numpy`` / ``aggregation_from_numpy`` do
the same for a metric aggregator's ``AggregationResult`` (K14's inputs):
its fields are numpy arrays, ints and entity keys in both packages.  This
module imports no JAX: the caller does the reading.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.tensor_model import (STATIC_FIELDS, TENSOR_FIELDS,
                                                         TensorClusterModel)
from cruise_control_tpu_torch.monitor.aggregator import AggregationResult


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


AGGREGATION_FIELDS = tuple(f.name for f in dataclasses.fields(AggregationResult))


def aggregation_to_numpy(res) -> Dict[str, object]:
    """Every field of an ``AggregationResult`` of either package: copies of
    its arrays, its generation and its entity keys."""
    out = {f: np.array(getattr(res, f), copy=True)
           for f in AGGREGATION_FIELDS if f not in ("generation", "entities")}
    out["generation"] = int(res.generation)
    out["entities"] = list(res.entities)
    return out


def aggregation_from_numpy(fields: Dict[str, object]) -> AggregationResult:
    """The port's ``AggregationResult`` from ``aggregation_to_numpy``'s dict
    (arrays keep their types: f32 values, bool validity, i8
    extrapolations, i64 window starts)."""
    missing = [f for f in AGGREGATION_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing aggregation fields: {missing}")
    return AggregationResult(
        **{f: np.array(fields[f], copy=True) for f in AGGREGATION_FIELDS
           if f not in ("generation", "entities")},
        generation=int(fields["generation"]), entities=list(fields["entities"]))
