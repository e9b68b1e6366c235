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
batch-axis reductions that take no fabric (`ScalarShare.sum`) reduce over.
"""

from __future__ import annotations

import threading

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
