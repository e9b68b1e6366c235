"""Offline-phase data structures: sizing, stores, and the prep result.

Counterpart of `ark_mpc_tpu/offline/structs.py` (`offline-phase/src/
structs.rs`): `OfflineSizingParams` (`structs.rs:27-37`), the FIFO stores
of generated material, and `LowGearPrep` (`structs.rs:122-196`), a
`PreprocessingPhase` the online fabric consumes directly.

`save` and `load` use the reference's `.npz` layout: the same keys, limbs
as (16, n) uint32 Montgomery-form arrays, so a prep saved by either package
loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..algebra.scalar import Scalar
from ..algebra.share import ScalarShare
from ..device import resolve_device
from .base import PreprocessingPhase


@dataclass
class OfflineSizingParams:
    """How much of each material to generate (`structs.rs:27-37`)."""

    num_triples: int = 1 << 12
    num_inverse_pairs: int = 1 << 10
    num_bits: int = 1 << 10
    num_randomness: int = 1 << 10
    num_input_masks: int = 1 << 10


class _Store:
    """FIFO store of batched ScalarShares, consumed via split-off
    (`structs.rs` LowGearPrep consuming stores via `split_off`)."""

    def __init__(self, parts: int):
        self.parts = parts
        self.items: list[tuple] = []  # list of tuples of ScalarShare

    def add(self, *shares):
        if len(shares) != self.parts:
            raise ValueError(f"store takes {self.parts} shares a batch, got {len(shares)}")
        self.items.append(tuple(shares))

    def __len__(self):
        return sum(int(t[0].size) for t in self.items)

    def take(self, n: int):
        """Pop n elements (concatenating/splitting stored batches)."""
        taken: list[list[ScalarShare]] = [[] for _ in range(self.parts)]
        need = n
        while need > 0:
            if not self.items:
                raise RuntimeError(f"offline store exhausted: need {need} more elements")
            batch = self.items.pop(0)
            size = int(batch[0].size)
            if size <= need:
                for i, s in enumerate(batch):
                    taken[i].append(s)
                need -= size
            else:
                for i, s in enumerate(batch):
                    taken[i].append(s.local[:need])
                self.items.insert(0, tuple(s.local[need:] for s in batch))
                need = 0
        out = tuple(ScalarShare.concatenate(parts) if len(parts) > 1 else parts[0]
                    for parts in taken)
        return out if self.parts > 1 else out[0]


def _limbs_u32(x: Scalar) -> np.ndarray:
    return x.limbs.cpu().numpy().astype(np.uint32)


@dataclass
class LowGearPrep(PreprocessingPhase):
    """Offline result consumed by the online fabric (`structs.rs:122-196`)."""

    mac_key_share: Scalar
    triples: _Store = field(default_factory=lambda: _Store(3))
    inverse_pairs: _Store = field(default_factory=lambda: _Store(2))
    bits: _Store = field(default_factory=lambda: _Store(1))
    randomness: _Store = field(default_factory=lambda: _Store(1))
    # input masks: (my cleartext masks, my shares of them) and counterparty
    my_masks_clear: list = field(default_factory=list)
    my_mask_shares: _Store = field(default_factory=lambda: _Store(1))
    counterparty_mask_shares: _Store = field(default_factory=lambda: _Store(1))

    def get_mac_key_share(self) -> Scalar:
        return self.mac_key_share

    def next_triplet_batch(self, n: int):
        return self.triples.take(n)

    def next_shared_inverse_pair_batch(self, n: int):
        return self.inverse_pairs.take(n)

    def next_shared_bit_batch(self, n: int):
        return self.bits.take(n)

    def next_shared_value_batch(self, n: int):
        return self.randomness.take(n)

    def next_local_input_mask_batch(self, n: int):
        # consume n cleartext masks across stored batches
        taken: list[Scalar] = []
        need = n
        while need > 0:
            if not self.my_masks_clear:
                raise RuntimeError("input-mask store exhausted")
            batch = self.my_masks_clear.pop(0)
            if batch.size <= need:
                taken.append(batch)
                need -= batch.size
            else:
                taken.append(batch.local[:need])
                self.my_masks_clear.insert(0, batch.local[need:])
                need = 0
        clear = taken[0] if len(taken) == 1 else Scalar.concatenate(taken)
        return clear, self.my_mask_shares.take(n)

    def next_counterparty_input_mask_batch(self, n: int):
        return self.counterparty_mask_shares.take(n)

    # -- persistence (checkpoint/resume parity) ----------------------------
    def save(self, path: str):
        arrays = {"mac_key": _limbs_u32(self.mac_key_share)}
        for name, store in self._stores().items():
            for idx, batch in enumerate(store.items):
                for j, share in enumerate(batch):
                    arrays[f"{name}.{idx}.{j}.share"] = _limbs_u32(share.share)
                    arrays[f"{name}.{idx}.{j}.mac"] = _limbs_u32(share.mac)
        for idx, clear in enumerate(self.my_masks_clear):
            arrays[f"masks_clear.{idx}"] = _limbs_u32(clear)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "LowGearPrep":
        """Read a prep saved by either package onto `device` (default: the
        CUDA card)."""
        device = resolve_device(device)

        def scalar(arr) -> Scalar:
            arr = np.asarray(arr)
            if arr.dtype != np.uint32 or arr.shape[:1] != (16,) or arr.max(initial=0) > 0xFFFF:
                raise ValueError(f"prep limbs must be (16, ...) uint32 16-bit values, got "
                                 f"{arr.dtype} {arr.shape}")
            return Scalar(torch.from_numpy(arr.astype(np.int32)).to(device))

        with np.load(path) as data:
            prep = cls(mac_key_share=scalar(data["mac_key"]))
            stores = prep._stores()
            batches: dict = {}
            for key in data.files:
                if key == "mac_key" or key.startswith("masks_clear."):
                    continue
                name, idx, j, kind = key.rsplit(".", 3)
                batches.setdefault((name, int(idx)), {}).setdefault(int(j), {})[kind] = \
                    scalar(data[key])
            for name, idx in sorted(batches, key=lambda t: t[1]):
                parts = batches[(name, idx)]
                stores[name].add(*(ScalarShare(parts[j]["share"], parts[j]["mac"])
                                   for j in sorted(parts)))
            n_clear = sum(1 for k in data.files if k.startswith("masks_clear."))
            for idx in range(n_clear):
                prep.my_masks_clear.append(scalar(data[f"masks_clear.{idx}"]))
        return prep

    def _stores(self):
        return {
            "triples": self.triples,
            "inverse_pairs": self.inverse_pairs,
            "bits": self.bits,
            "randomness": self.randomness,
            "my_mask_shares": self.my_mask_shares,
            "counterparty_mask_shares": self.counterparty_mask_shares,
        }
