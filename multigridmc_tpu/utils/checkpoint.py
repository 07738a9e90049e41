"""Chain checkpoint / resume.

The reference has no checkpointing - chains are regenerated from fixed seeds
(SURVEY.md section 5; ``driver_mgmc.cc:448-449``).  For long production sampling
runs this module adds durable chain state: the sampler state is just
``(x, key, step)`` (plus accumulated statistics), saved as a compressed npz with
integrity metadata and restored exactly - resuming a chain continues the same
Markov chain (the kernel is memoryless given ``(x, key)``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np


@dataclasses.dataclass
class ChainState:
    """Complete MCMC chain state."""

    x: Any  # chain state field(s), (*, *vshape)
    key: Any  # jax PRNG key
    step: int
    stats: Optional[Dict[str, Any]] = None  # e.g. running sums

    def save(self, path) -> None:
        path = Path(path)
        key_dtype = getattr(self.key, "dtype", None)
        is_typed_key = key_dtype is not None and jax.dtypes.issubdtype(
            key_dtype, jax.dtypes.prng_key
        )
        payload = {
            "x": np.asarray(self.x),
            "key": np.asarray(jax.random.key_data(self.key))
            if is_typed_key
            else np.asarray(self.key),
            "step": np.asarray(self.step),
        }
        # record the PRNG impl so non-default keys (e.g. 'rbg' on accelerator
        # runs) resume with the same random stream; raw uint32 keys round-trip
        # as raw arrays rather than being silently wrapped
        meta = {
            "version": 2,
            "stats_keys": [],
            "key_impl": str(jax.random.key_impl(self.key)) if is_typed_key else None,
        }
        if self.stats:
            for k, v in self.stats.items():
                payload[f"stat_{k}"] = np.asarray(v)
                meta["stats_keys"].append(k)
        payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        tmp.replace(path)  # atomic on POSIX

    @classmethod
    def load(cls, path) -> "ChainState":
        with np.load(Path(path)) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            key_data = data["key"]
            # version-1 checkpoints recorded no impl; they were only ever
            # written for typed default-impl keys, so wrap with the default
            impl = meta.get("key_impl", "__wrap_default__")
            if impl is None:
                key = np.asarray(key_data)  # raw (untyped) key array
            elif impl == "__wrap_default__":
                key = jax.random.wrap_key_data(np.asarray(key_data, dtype=np.uint32))
            else:
                key = jax.random.wrap_key_data(
                    np.asarray(key_data, dtype=np.uint32), impl=impl
                )
            stats = {k: data[f"stat_{k}"] for k in meta["stats_keys"]} or None
            return cls(
                x=np.asarray(data["x"]),
                key=key,
                step=int(data["step"]),
                stats=stats,
            )
