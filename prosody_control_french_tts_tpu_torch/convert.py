"""Carry parameters across from the JAX package to this port.

The measure step has no learned weights: what crosses is the parameter
dataclasses. The functions here read the JAX objects' fields by name, duck-
typed (the JAX package is never imported), and build this port's
dataclasses; a field the port does not know raises, so a parameter can
never be dropped silently.

Later slices add here the ``.npz`` → ``state_dict`` converters of the JAX
package's packaged checkpoints (the break tagger, the aligners, the LLM).
"""

from __future__ import annotations

import dataclasses

from .ops.pitch import PitchParams
from .prosody.adjust import ProsodySettings


def _fields_of(obj) -> dict:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return dict(obj)
    return dict(vars(obj))


def _convert(obj, cls):
    values = _fields_of(obj)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    return cls(**values)


def pitch_params_from_jax(obj) -> PitchParams:
    """The port's PitchParams with every field of the JAX ``PitchParams``."""
    return _convert(obj, PitchParams)


def prosody_settings_from_jax(obj) -> ProsodySettings:
    """The port's ProsodySettings with every field of the JAX
    ``ProsodySettings``."""
    return _convert(obj, ProsodySettings)
