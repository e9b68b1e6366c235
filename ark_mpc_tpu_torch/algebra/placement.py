"""Where a batch lives on a mesh: the rank's shard, or replicated.

A mesh-attached fabric (`fabric/context.py`) runs one process a rank, and
every value a rank holds is one of two placements:

  - a shard: the rank's columns of a global batch (leading axis).  Every
    multi-element share the fabric makes from a global batch is one, and so
    is the value opened from it (a 0-d value is a constant and mixes with
    either placement);
  - replicated: a value every rank of the party holds whole, with the same
    limbs, marked by `replicated = True`.  Reductions over the batch axis
    give one (`ScalarShare.sum`, `PointShare.sum`, MSM), and so do a shared
    polynomial, a matrix triple's Q, the opened E of a shared matmul, the
    values opened from replicated shares, and what element-wise operations
    make of replicated operands.

Off a mesh every share is a shard and no mark changes a result.  Share types carry
the mark as a bool field.  Public values (`FieldArray`, `CurvePoint`,
`G1`) carry it as an attribute with three states: True (replicated), False
(a shard: a value opened from a shard, or the rank's slice of a global
batch) and None, the class default (a value made locally, whose placement
the rule cannot read).  An element-wise operation on shares takes its
placement from `placement`, which raises `ValueError` naming the mesh
where a shard meets a replicated batch of more than one element: element i
of a shard is not element i of the whole.  A public operand counts where
it is marked either way, so a replicated share of one element beside an
opened shard gives a shard, and a wider one raises; an unmarked public
batch beside a replicated share is taken as whole (a public value every
rank computed alike, such as a polynomial's coefficients).  Public results
keep a mark: replicated where `FieldArray._bin` says so, else a shard where
an operand is one.  A fabric slices only an unmarked batch it is given
whole (`share_public`): a shard is never cut again.

The mesh of the fabric a thread runs (`MpcFabric` sets it) is what
batch-axis reductions that take no fabric (`ScalarShare.sum`) reduce over,
and what a shard's global view reads.

The global view: on that mesh, indexing a shard selects global positions,
as indexing the reference's global array does (`global_item`): an integer
(also negative), a slice, a list or an integer array (numpy or torch) of
positions, a boolean mask, and on a shard of more than one axis a tuple of
these (`x[i, j]`, `x[:, j]`).  Each is one all-gather over the party's
ranks, the index, then the small-batch rule: a result whose leading axis
is at least the mesh size and a multiple of it is a shard, any other is
held replicated (whole on every rank, as the reference holds a global array
whose size the mesh does not divide).  An index of a type the reference
refuses (a float, say) raises `TypeError`, on a shard before any
collective.  `reshape` of a shard is the global reshape (`global_reshape`):
the shape is the global batch's, or `ValueError` naming the mesh.
`x.local[idx]` and `x.local.reshape(*shape)` index and reshape the rank's
own elements with no collective: what the fabric's internals mean by an
index or a shape.  Off a mesh, and on a replicated or unmarked value, the
global and the local forms agree.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

_THREAD = threading.local()


def set_thread_mesh(mesh) -> None:
    """Record the mesh of the fabric this thread runs (`MpcFabric` calls it)."""
    _THREAD.mesh = mesh


def thread_mesh():
    """The mesh of this thread's fabric, or None."""
    return getattr(_THREAD, "mesh", None)


def mark(x, replicated: bool = True):
    """x, marked replicated (or, with False, a shard); -> x."""
    x.replicated = replicated
    return x


def mixing_error(what: str, n: int) -> ValueError:
    mesh = thread_mesh()
    size = f"{mesh.size}-rank " if mesh is not None else ""
    return ValueError(
        f"{what} mixes a shard of the {size}mesh with a replicated batch of {n} "
        f"element{'s' if n != 1 else ''} (every rank holds the whole of it, and "
        f"element i of a shard is not element i of the whole); gather the "
        f"shard or keep the operands in one placement")


def placement(*operands) -> bool:
    """Whether an element-wise result of `operands` is replicated: all of
    them are marked or 0-d, and at least one is marked.  A shard beside a
    marked operand of one element (which broadcasts like a constant) gives
    a shard; beside a marked batch of more than one element, `ValueError`
    naming the mesh."""
    rep = [o for o in operands if o.replicated]
    if not rep:
        return False
    if all(o.replicated or not o.shape for o in operands):
        return True
    wide = [o.size for o in rep if o.size > 1]
    if wide:
        raise mixing_error("an element-wise operation", wide[0])
    return False


def with_public(share, public) -> bool:
    """The placement of a share operated on with a public value (a field
    array, a point batch or a plain integer): the public value counts where
    it is marked, replicated or shard; unmarked, the share's placement
    stands."""
    if getattr(public, "replicated", None) is None:
        return share.replicated
    return placement(share, public)


def same_placement(items) -> bool:
    """The placement of a concatenation: every item's, or `ValueError`
    naming the mesh where shards and replicated batches meet (the result
    would be neither)."""
    flags = {bool(it.replicated) for it in items}
    if len(flags) > 1:
        n = next(it.size for it in items if it.replicated)
        raise mixing_error("a concatenation", n)
    return flags.pop()


def join(items: list, replicated: bool | None = None):
    """The items' own elements end to end (flat, in item order) as one
    share of their type (`ScalarShare` or `PointShare`), whatever their
    placements: what a fused call sends and computes on.  It is marked
    `replicated` (default: where every item is), else a shard; a join of
    mixed placements is a fused call's internal value, which `split`
    takes apart."""
    flat = [it.local.reshape(it.size) for it in items]
    if replicated is None:
        replicated = all(it.replicated for it in flat)
    if len(flat) == 1:
        return type(flat[0])(flat[0].share, flat[0].mac, replicated)
    kind = type(flat[0].share)
    return type(flat[0])(kind.concatenate([it.share for it in flat]),
                         kind.concatenate([it.mac for it in flat]), replicated)


def split(value, items: list, placements: list | None = None) -> list:
    """`value`'s consecutive slices of the items' sizes, each marked with its
    item's placement (or `placements`'s) and shaped as the item: the
    results of a fused call on `join(items)`."""
    if placements is None:
        placements = [it.replicated for it in items]
    out, at = [], 0
    for it, rep in zip(items, placements):
        part = value.local[at:at + it.size]
        at += it.size
        out.append(mark(part, bool(rep)).local.reshape(*it.shape))
    return out


class LocalView:
    """`x.local[idx]` and `x.local.reshape(*shape)`: x's own elements at
    positions `idx` of the rank's tensor, or reshaped to a shape of the
    rank's elements, with no collective (the forms before the global
    view)."""

    __slots__ = ("_x",)

    def __init__(self, x):
        self._x = x

    def __getitem__(self, idx):
        return self._x._take(idx)

    def reshape(self, *shape):
        return self._x._reshape(_shape_arg(shape))


def _shape_arg(shape: tuple) -> tuple:
    """`reshape(2, 3)` or `reshape((2, 3))`: -> (2, 3)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return shape


class GlobalView:
    """Indexing and `reshape` through the global view (module docstring)
    for field arrays, point batches and their shares, which define the
    rank-local forms `_take(idx)` and `_reshape(shape)`."""

    __slots__ = ()

    def __getitem__(self, idx):
        return global_item(self, idx)

    @property
    def local(self) -> LocalView:
        return LocalView(self)

    def reshape(self, *shape):
        return global_reshape(self, _shape_arg(shape))


def shard_mesh(x):
    """This thread's mesh where x is a shard on it (marked a shard, with a
    batch axis), else None."""
    mesh = thread_mesh()
    if mesh is None or x.replicated is not False or not x.shape:
        return None
    return mesh


def _place_selection(whole, mesh):
    """A global value selected from a shard (gathered, so marked
    replicated), placed by the small-batch rule: the rank's shard where its
    leading axis is at least the mesh size and a multiple of it, else held
    replicated as it is (fewer elements than the mesh, a single value, or a
    size the mesh does not divide)."""
    from ..parallel.step import shard

    n = whole.shape[0] if whole.shape else 0
    if n >= mesh.size and n % mesh.size == 0:
        return shard(whole, mesh)
    return whole


def _integral(part) -> bool:
    """Whether one part of an index is of a type the reference takes: an
    integer, a slice, None, an ellipsis, or a sequence or array of integers
    or booleans."""
    if part is None or part is Ellipsis or isinstance(part, (slice, int, np.integer, np.bool_)):
        return True
    if isinstance(part, torch.Tensor):
        return not (part.is_floating_point() or part.is_complex())
    arr = np.asarray(part)
    return arr.size == 0 or arr.dtype.kind in "biu"


def global_item(x, idx):
    """x[idx], on a shard the global batch's positions: any index the
    reference takes (module docstring); -> the selection, placed by the
    small-batch rule.  Every rank of the party calls it alike (one
    all-gather).  Off a shard, `x.local[idx]`."""
    for part in idx if isinstance(idx, tuple) else (idx,):
        if not _integral(part):
            raise TypeError(f"Indexer must have integer or boolean type, got indexer "
                            f"{part!r}")
    mesh = shard_mesh(x)
    if mesh is None:
        return x._take(idx)
    from ..parallel.step import gather

    return _place_selection(gather(x, mesh)._take(idx), mesh)


def _resolve(shape: tuple, n: int):
    """`shape` with its -1 resolved for n elements, or None where it does
    not fit them."""
    known = math.prod(d for d in shape if d != -1)
    if -1 in shape:
        if known == 0 or n % known:
            return None
        return tuple(n // known if d == -1 else d for d in shape)
    return shape if known == n else None


def global_reshape(x, shape: tuple):
    """x.reshape(*shape), on a shard the global batch's: a shape whose rows
    the mesh size divides is the rank's rows of it (its chunk of the
    row-major batch, no collective); any other is gathered, reshaped and
    placed by the small-batch rule (rows the mesh size does not divide:
    replicated).  A shape that does not fit the global batch raises
    `ValueError` naming the mesh.  Off a shard, `x.local.reshape(*shape)`."""
    mesh = shard_mesh(x)
    if mesh is None:
        return x._reshape(shape)
    n = x.size * mesh.size
    full = _resolve(shape, n)
    if full is None:
        raise ValueError(
            f"reshape to {shape} of a shard of the {mesh.size}-rank mesh: its global "
            f"batch of {n} elements does not take that shape (a shard's shape is the "
            f"global batch's; reshape the rank's own elements with `.local.reshape`)")
    if full and full[0] >= mesh.size and full[0] % mesh.size == 0:
        return x._reshape((full[0] // mesh.size,) + full[1:])
    from ..parallel.step import gather

    return _place_selection(gather(x, mesh)._reshape(full), mesh)
