"""Batched circuit scheduler: trace, level, fuse, flush.

Counterpart of `ark_mpc_tpu/fabric/scheduler.py`, the static replacement
for a per-gate, out-of-order gate executor:

  - users build circuits with operator overloading on `TracedShare`;
    building is pure graph construction;
  - `run()` levels the DAG by communication depth (open/Beaver rounds on
    the longest dependency path);
  - per level, ALL Beaver multiplications fuse into ONE batched mul (one
    triple batch, one wire exchange, one `beaver_round` launch on the card),
    all inversions into one batched inversion, all scalar x point products
    into one Beaver point product, and the opens that later levels read
    into one authenticated open; terminal opens flush together at the end
    with ONE deferred MAC check;
  - linear gates with coefficients known at trace time (add/sub/neg,
    mul/add by constants) fold symbolically into affine forms
    `sum_i c_i * [base_i] + public`, so a long add chain is ONE combine.
    Forms are capped at `_MAX_TERMS` bases; wider fan-ins materialize
    intermediate bases.

Nodes register with their tracer at creation, so creation order IS a
topological order; leveling is two linear passes (reachability backward,
depth and forms forward) with no recursion.  Constants the scheduler makes
(coefficients, the 0 and 1 of `pow(0)`) live on the fabric's device.

On a mesh a level may hold shards and replicated values (a `sum` is
replicated, `algebra/placement.py`).  They are never concatenated: a
level's opens send one group of each placement side by side in the same
exchange, and its muls, inversions and point products make one fused call
for each placement present (so a level that mixes them takes a round
more).  Every rank's groups are then equal in size (equal shards, the same
replicated values), so each rank slices its results back the same way.
"""

from __future__ import annotations

import functools

from ..algebra.fields import SCALAR_FIELD
from ..algebra.placement import placement
from ..algebra.scalar import Scalar, public_exponent
from ..algebra.share import ScalarShare
from .context import MpcFabric

# ops whose output is an affine function of share-typed deps with
# coefficients known at TRACE time (payload constants); these fold into
# symbolic forms and cost zero dispatches per gate
_LINEAR = frozenset(("add", "sub", "neg", "mul_pub", "add_pub"))
_COMM = frozenset(("mul", "inv", "pmul", "open"))
_MAX_TERMS = 12  # affine-form width cap: wider fan-ins materialize a base
_L_MOD = SCALAR_FIELD.modulus


class _Node:
    __slots__ = ("op", "deps", "payload", "shape", "nid")

    # share ops:  input | add | sub | neg | mul_pub | add_pub | mul | inv
    #             | sum | mul_pubv | add_pubv | sub_pubv | rsub_pubv
    # point ops:  pinput | padd | psub | pneg | pmul_pub | pmul | psum
    # public ops: open | pub_add | pub_sub | pub_mul | pub_neg | pub_c
    #             | pub_fn
    def __init__(self, op, deps, payload, shape, nid):
        self.op = op
        self.deps = deps
        self.payload = payload
        self.shape = shape
        self.nid = nid


class TracedShare:
    """Symbolic authenticated share batch inside a traced circuit."""

    __slots__ = ("tracer", "node", "shape")

    def __init__(self, tracer: "Tracer", node: _Node, shape: tuple):
        self.tracer = tracer
        self.node = node
        self.shape = shape

    # -- operator surface (mirrors AuthenticatedScalarResult) --------------
    def _lift(self, other):
        if isinstance(other, TracedShare):
            return other
        if isinstance(other, ScalarShare):
            return self.tracer.wrap(other)
        return NotImplemented

    def __add__(self, other):
        if type(other) is TracedShare:  # hot path: share + share
            return self.tracer._mk("add", (self, other), None, self.shape)
        if isinstance(other, Scalar):
            return self.tracer._mk("add_pub", (self,), other, self.shape)
        if isinstance(other, TracedPublic):
            return self.tracer._mk("add_pubv", (self, other), None,
                                   self.shape)
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        return self.tracer._mk("add", (self, other), None, self.shape)

    __radd__ = __add__

    def __sub__(self, other):
        if type(other) is TracedShare:
            return self.tracer._mk("sub", (self, other), None, self.shape)
        if isinstance(other, Scalar):
            return self.tracer._mk("add_pub", (self,), -other, self.shape)
        if isinstance(other, TracedPublic):
            return self.tracer._mk("sub_pubv", (self, other), None,
                                   self.shape)
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        return self.tracer._mk("sub", (self, other), None, self.shape)

    def __neg__(self):
        return self.tracer._mk("neg", (self,), None, self.shape)

    def __mul__(self, other):
        if isinstance(other, Scalar):
            return self.tracer._mk("mul_pub", (self,), other, self.shape)
        if isinstance(other, TracedPublic):
            return self.tracer._mk("mul_pubv", (self, other), None,
                                   self.shape)
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        assert other.shape == self.shape, "traced mul requires equal shapes"
        return self.tracer._mk("mul", (self, other), None, self.shape)

    __rmul__ = __mul__

    def inverse(self):
        return self.tracer._mk("inv", (self,), None, self.shape)

    def pow(self, e: int) -> "TracedShare":
        """Public-exponent power by square-and-multiply: the mul nodes land
        on consecutive levels, so a BATCH of pows shares one Beaver round
        per squaring step (the windowed form of `context.pow`).  A negative e
        raises `ValueError` before any node is traced."""
        e = public_exponent(e)
        if e == 0:
            dev = self.tracer.fabric.device
            return ((self * Scalar.from_ints(0, device=dev))
                    + Scalar.from_ints(1, device=dev))
        result, base = None, self
        while e:
            if e & 1:
                result = base if result is None else result * base
            e >>= 1
            if e:
                base = base * base
        return result

    __pow__ = pow

    def sum(self):
        return self.tracer._mk("sum", (self,), None, ())

    def open(self) -> "TracedOpen":
        return self.tracer.open(self)


class TracedOpen:
    """Handle to a value that will be opened at flush time.

    `as_public()` turns the (future) opened value into a `TracedPublic`
    usable in LATER traced computation — the reference fabric's arbitrary
    dataflow through opens (`fabric.rs:820-870`).  Opens that feed later
    levels flush mid-circuit at their communication level; terminal opens
    still flush together once at the end."""

    __slots__ = ("source", "value", "node")

    def __init__(self, source: TracedShare):
        self.source = source
        self.value: Scalar | None = None
        self.node = None  # the "open" _Node, once as_public() materializes

    def as_public(self) -> "TracedPublic":
        if self.node is None:
            tr = self.source.tracer
            self.node = tr._new_node("open", (self.source.node,), None,
                                     self.source.node.shape)
        return TracedPublic(self.source.tracer, self.node,
                            self.source.shape)


class TracedPublic:
    """Symbolic PUBLIC value inside a trace (an opened value or a function
    of one).  All arithmetic is communication-free; `apply` lifts any
    Scalar -> Scalar function (e.g. `Scalar.inverse`, prefix scans)."""

    __slots__ = ("tracer", "node", "shape")

    def __init__(self, tracer: "Tracer", node: _Node, shape: tuple):
        self.tracer = tracer
        self.node = node
        self.shape = shape

    def _lift(self, other):
        if isinstance(other, TracedPublic):
            return other
        if isinstance(other, Scalar):
            return TracedPublic(
                self.tracer,
                self.tracer._new_node("pub_c", (), other,
                                      tuple(other.shape)),
                other.shape)
        return None

    def __add__(self, other):
        if isinstance(other, TracedShare):
            return other + self
        o = self._lift(other)
        if o is None:
            return NotImplemented
        return TracedPublic(
            self.tracer,
            self.tracer._new_node("pub_add", (self.node, o.node), None,
                                  self.node.shape), self.shape)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, TracedShare):
            return self.tracer._mk("rsub_pubv", (other, self), None,
                                   other.shape)
        o = self._lift(other)
        if o is None:
            return NotImplemented
        return TracedPublic(
            self.tracer,
            self.tracer._new_node("pub_sub", (self.node, o.node), None,
                                  self.node.shape), self.shape)

    def __neg__(self):
        return TracedPublic(
            self.tracer,
            self.tracer._new_node("pub_neg", (self.node,), None,
                                  self.node.shape), self.shape)

    def __mul__(self, other):
        if isinstance(other, TracedShare):
            return other * self
        o = self._lift(other)
        if o is None:
            return NotImplemented
        return TracedPublic(
            self.tracer,
            self.tracer._new_node("pub_mul", (self.node, o.node), None,
                                  self.node.shape), self.shape)

    __rmul__ = __mul__

    def apply(self, fn, shape=None) -> "TracedPublic":
        """Arbitrary public post-processing of an opened value: `fn` maps
        the concrete `Scalar` to a `Scalar` at flush time."""
        shape = self.shape if shape is None else shape
        return TracedPublic(
            self.tracer,
            self.tracer._new_node("pub_fn", (self.node,), fn, tuple(shape)),
            shape)

    def inverse(self) -> "TracedPublic":
        return self.apply(lambda s: s.inverse())


class TracedPointShare:
    """Symbolic authenticated point batch inside a traced circuit
    (the `AuthenticatedPointResult` role).  Linear ops are free; scalar x
    point Beaver multiplications fuse per communication level like scalar
    muls; point opens flush together."""

    __slots__ = ("tracer", "node", "shape")

    def __init__(self, tracer: "Tracer", node: _Node, shape: tuple):
        self.tracer = tracer
        self.node = node
        self.shape = shape

    def __add__(self, other: "TracedPointShare"):
        return self.tracer._mkp("padd", (self, other), None, self.shape)

    def __sub__(self, other: "TracedPointShare"):
        return self.tracer._mkp("psub", (self, other), None, self.shape)

    def __neg__(self):
        return self.tracer._mkp("pneg", (self,), None, self.shape)

    def mul_public(self, k: Scalar):
        return self.tracer._mkp("pmul_pub", (self,), k, self.shape)

    def mul(self, scalar: TracedShare):
        """[x] * [P] via the generator-trick Beaver protocol; fused with
        other level-mates into one round."""
        assert scalar.shape == self.shape
        return self.tracer._mkp("pmul", (self, scalar), None, self.shape)

    def sum(self):
        return self.tracer._mkp("psum", (self,), None, ())

    def open(self) -> "TracedPointOpen":
        handle = TracedPointOpen(self)
        self.tracer.point_opens.append(handle)
        return handle


class TracedPointOpen:
    __slots__ = ("source", "value")

    def __init__(self, source: TracedPointShare):
        self.source = source
        self.value = None  # CurvePoint after run()


class Tracer:
    """Collects a circuit, then executes it round-by-round."""

    def __init__(self, fabric: MpcFabric):
        self.fabric = fabric
        self.opens: list[TracedOpen] = []
        self.point_opens: list[TracedPointOpen] = []
        self.nodes: list[_Node] = []  # creation order == topological order

    def _new_node(self, op, deps, payload, shape) -> _Node:
        nodes = self.nodes
        n = _Node(op, deps, payload, shape, len(nodes))
        nodes.append(n)
        return n

    def wrap(self, share: ScalarShare) -> TracedShare:
        node = self._new_node("input", (), share, tuple(share.shape))
        return TracedShare(self, node, share.shape)

    def wrap_points(self, share) -> TracedPointShare:
        node = self._new_node("pinput", (), share, tuple(share.shape))
        return TracedPointShare(self, node, share.shape)

    def _mk(self, op, deps, payload, shape) -> TracedShare:
        nodes = self.nodes
        node = _Node(op, tuple(d.node for d in deps), payload,
                     tuple(shape), len(nodes))
        nodes.append(node)
        return TracedShare(self, node, shape)

    def _mkp(self, op, deps, payload, shape) -> TracedPointShare:
        node = self._new_node(op, tuple(d.node for d in deps), payload,
                              tuple(shape))
        return TracedPointShare(self, node, shape)

    def open(self, ts: TracedShare) -> TracedOpen:
        handle = TracedOpen(ts)
        self.opens.append(handle)
        return handle

    # -- execution ---------------------------------------------------------
    def run(self, outputs: list[TracedShare] | None = None,
            verify: bool = True) -> list[ScalarShare]:
        """Evaluate the circuit: fuse per-round muls/invs, flush opens once,
        run ONE deferred MAC check at the end (when `verify`)."""
        import gc

        # the passes below allocate millions of short-lived dicts/tuples on
        # big circuits; cyclic GC sweeps over the (acyclic) node graph grow
        # superlinear — pause collection for the duration
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            return self._run(outputs or [], verify)
        finally:
            if gc_was_enabled:
                gc.enable()

    def _run(self, outputs, verify):
        roots = ([o.node for o in outputs]
                 + [(h.node or h.source.node) for h in self.opens]
                 + [h.source.node for h in self.point_opens])
        nodes = self.nodes
        n_nodes = len(nodes)

        # ---- pass 1 (backward): reachability from the roots --------------
        marked = bytearray(n_nodes)
        for r in roots:
            marked[r.nid] = 1
        for i in range(n_nodes - 1, -1, -1):
            if marked[i]:
                for d in nodes[i].deps:
                    marked[d.nid] = 1

        # ---- pass 2 (forward): depth + symbolic affine forms --------------
        # forms[i] = (terms: {base_nid: int|Scalar}, pub: Scalar|None) for
        # share-typed nodes; None for point/public/apply-evaluated nodes.
        # mat_form[i] keeps the original form of a node that was forced to
        # become a base (fan-in cap) so its VALUE can still be combined.
        values: dict[int, object] = {}
        forms: list = [None] * n_nodes
        mat_form: dict[int, tuple] = {}
        depth = [0] * n_nodes
        by_level: dict[int, dict[str, list[_Node]]] = {}
        max_depth = 0

        def as_base(n: _Node):
            i = n.nid
            f = forms[i]
            if f is None or (len(f[0]) == 1 and f[1] is None
                             and i in f[0]):
                return
            mat_form[i] = f
            forms[i] = ({i: 1}, None)

        for i in range(n_nodes):
            if not marked[i]:
                continue
            n = nodes[i]
            op = n.op
            deps = n.deps
            d = 0
            for dep in deps:
                dd = depth[dep.nid]
                if dd > d:
                    d = dd
            if op in _COMM:
                d += 1
                if d > max_depth:
                    max_depth = d
                by_level.setdefault(d, {}).setdefault(op, []).append(n)
            depth[i] = d
            if op == "input":
                values[i] = n.payload
                forms[i] = ({i: 1}, None)
            elif op == "add" or op == "sub":
                fa = forms[deps[0].nid]
                fb = forms[deps[1].nid]
                if len(fa[0]) + len(fb[0]) > _MAX_TERMS:
                    # materialize the wider operand as a fresh base
                    as_base(deps[0] if len(fa[0]) >= len(fb[0]) else deps[1])
                    fa = forms[deps[0].nid]
                    fb = forms[deps[1].nid]
                terms = dict(fa[0])
                if op == "add":
                    for b, c in fb[0].items():
                        terms[b] = terms[b] + c if b in terms else c
                    pa, pb = fa[1], fb[1]
                    pub = pa if pb is None else (pb if pa is None
                                                 else pa + pb)
                else:
                    for b, c in fb[0].items():
                        terms[b] = terms[b] - c if b in terms else (
                            -c if isinstance(c, int) else -c)
                    pa, pb = fa[1], fb[1]
                    pub = pa if pb is None else (-pb if pa is None
                                                 else pa - pb)
                forms[i] = (terms, pub)
            elif op == "neg":
                f = forms[deps[0].nid]
                forms[i] = ({b: -c for b, c in f[0].items()},
                            None if f[1] is None else -f[1])
            elif op == "mul_pub":
                f = forms[deps[0].nid]
                k = n.payload
                terms = {}
                for b, c in f[0].items():
                    terms[b] = k if (isinstance(c, int) and c == 1) \
                        else _coeff_mul(c, k)
                forms[i] = (terms, None if f[1] is None else f[1] * k)
            elif op == "add_pub":
                f = forms[deps[0].nid]
                forms[i] = (f[0],  # shared dict: add_pub never mutates terms
                            n.payload if f[1] is None else f[1] + n.payload)
            elif op in ("mul", "inv", "sum", "mul_pubv", "add_pubv",
                        "sub_pubv", "rsub_pubv"):
                # share-typed but not statically linear: becomes a base;
                # value computed by the round loop (comm) or apply path
                forms[i] = ({i: 1}, None)
            elif op == "pinput":
                values[i] = n.payload
            # point/public ops: forms stay None (apply path)

        fabric = self.fabric

        def combine(form) -> ScalarShare:
            terms, pub = form
            acc = None
            for b, c in terms.items():
                base = values[b]
                if isinstance(c, int):
                    if c == 1:
                        t = base
                    elif c == -1:
                        t = -base
                    else:
                        t = base.mul_public(Scalar.from_ints(
                            c % _L_MOD, device=fabric.device))
                else:
                    t = base.mul_public(c)
                acc = t if acc is None else acc + t
            if pub is not None:
                acc = acc.add_public(pub, fabric.mac_key, fabric.party_id)
            return acc

        def apply_op(n: _Node, deps: list) -> object:
            op = n.op
            if op in ("padd",):
                return deps[0] + deps[1]
            if op in ("psub",):
                return deps[0] - deps[1]
            if op in ("pneg",):
                return -deps[0]
            if op in ("pmul_pub",):
                return deps[0].mul_public(n.payload)
            if op in ("sum", "psum"):
                return deps[0].sum()
            # share (x) opened-public ops
            if op == "mul_pubv":
                return deps[0].mul_public(deps[1])
            if op == "add_pubv":
                return deps[0].add_public(
                    deps[1], fabric.mac_key, fabric.party_id)
            if op == "sub_pubv":
                return deps[0].add_public(
                    -deps[1], fabric.mac_key, fabric.party_id)
            if op == "rsub_pubv":
                return (-deps[0]).add_public(
                    deps[1], fabric.mac_key, fabric.party_id)
            # public-value ops (concrete Scalars at flush time)
            if op == "pub_c":
                return n.payload
            if op == "pub_add":
                return deps[0] + deps[1]
            if op == "pub_sub":
                return deps[0] - deps[1]
            if op == "pub_neg":
                return -deps[0]
            if op == "pub_mul":
                return deps[0] * deps[1]
            if op == "pub_fn":
                return n.payload(deps[0])
            # mul/inv/pmul/open are flushed by the round loop
            raise AssertionError(f"comm node {op} not yet flushed")

        def prereq_nodes(n: _Node):
            """Nodes whose VALUES must exist before n's can be computed."""
            i = n.nid
            f = mat_form.get(i) or (
                forms[i] if forms[i] is not None and n.op in _LINEAR
                else None)
            if f is not None:
                return [nodes[b] for b in f[0] if b not in values], f
            return [d for d in n.deps if d.nid not in values], None

        def eval_local(n: _Node):
            """Evaluate a communication-free node (memoized, iterative)."""
            v = values.get(n.nid)
            if v is not None:
                return v
            st = [n]
            while st:
                cur = st[-1]
                if cur.nid in values:
                    st.pop()
                    continue
                pending, f = prereq_nodes(cur)
                if pending:
                    st.extend(pending)
                    continue
                st.pop()
                if f is not None:
                    values[cur.nid] = combine(f)
                else:
                    values[cur.nid] = apply_op(
                        cur, [values[d.nid] for d in cur.deps])
            return values[n.nid]

        # round-by-round: batch ALL muls (and invs) of one depth level into
        # single fused protocol calls; mid-circuit opens (materialized via
        # `TracedOpen.as_public`) flush per level as ONE authenticated open.
        for level in range(1, max_depth + 1):
            lv = by_level.get(level, {})
            mids = lv.get("open", [])
            if mids:
                opened = _open_fused(fabric.open_authenticated_many,
                                     [eval_local(n.deps[0]).reshape(_numel(n))
                                      for n in mids])
                for n, v in zip(mids, opened):
                    values[n.nid] = v.reshape(*n.shape)
            muls = lv.get("mul", [])
            invs = lv.get("inv", [])
            if muls:
                lhs = [eval_local(n.deps[0]).reshape(_numel(n)) for n in muls]
                rhs = [eval_local(n.deps[1]).reshape(_numel(n)) for n in muls]
                for n, v in zip(muls, _fused(fabric.mul, lhs, rhs)):
                    values[n.nid] = v
            if invs:
                xs = [eval_local(n.deps[0]).reshape(_numel(n)) for n in invs]
                for n, v in zip(invs, _fused(
                        lambda x: fabric.inverse(x, defer_check=True), xs)):
                    values[n.nid] = v
            pmuls = lv.get("pmul", [])
            if pmuls:
                pts = [eval_local(n.deps[0]).reshape(_numel(n))
                       for n in pmuls]
                scs = [eval_local(n.deps[1]).reshape(_numel(n))
                       for n in pmuls]
                for n, v in zip(pmuls, _fused(fabric.mul_points, scs, pts)):
                    values[n.nid] = v

        # one coalesced open flush for everything still unopened (handles
        # whose open node already flushed mid-circuit just read the value)
        terminal = [h for h in self.opens
                    if h.node is None or h.node.nid not in values]
        for h in self.opens:
            if h.node is not None and h.node.nid in values:
                h.value = values[h.node.nid]
        if terminal:
            opened = _open_fused(fabric.open_authenticated_many, [
                eval_local(h.source.node).reshape(_numel(h.source.node))
                for h in terminal])
            for h, v in zip(terminal, opened):
                h.value = v.reshape(*h.source.shape)
        if self.point_opens:
            from . import points

            opened = _open_fused(
                functools.partial(points.open_authenticated_points_many, fabric),
                [eval_local(h.source.node).reshape(_numel(h.source.node))
                 for h in self.point_opens])
            for h, v in zip(self.point_opens, opened):
                h.value = v.reshape(*h.source.shape)
        if verify:
            fabric.verify_deferred()
        return [eval_local(o.node) for o in outputs]


def _groups(keys: list) -> list:
    """Item indices by placement key (shards first), empty groups left out."""
    return [idx for idx in ([i for i, k in enumerate(keys) if k == key]
                            for key in (False, True)) if idx]


def _split(result, items: list, idx: list, out: list) -> None:
    """out[i] = item i's slice of `result`, the fused result of `idx`'s
    items concatenated in order."""
    off = 0
    for i in idx:
        k = items[i].size
        out[i] = result[off: off + k]
        off += k


def _fused(call, *operands: list) -> list:
    """`call` on the concatenated flat operands of a level, once per
    placement present (never concatenating the two); -> each item's slice
    of its result, in item order."""
    keys = [placement(*ops) for ops in zip(*operands)]
    out = [None] * len(keys)
    for idx in _groups(keys):
        result = call(*(type(ops[0]).concatenate([ops[i] for i in idx])
                        for ops in operands))
        _split(result, operands[0], idx, out)
    return out


def _open_fused(open_many, items: list) -> list:
    """Deferred authenticated opens of a level's flat shares in ONE exchange:
    one concatenated group per placement, sent side by side."""
    groups = _groups([it.replicated for it in items])
    opened = open_many([type(items[0]).concatenate([items[i] for i in idx])
                        for idx in groups], defer=True)
    out = [None] * len(items)
    for idx, result in zip(groups, opened):
        _split(result, items, idx, out)
    return out


def _coeff_mul(c, k: Scalar):
    if isinstance(c, int):
        return k * Scalar.from_ints(c % _L_MOD, device=k.device) if c != 1 else k
    return c * k


def _numel(n: _Node) -> int:
    size = 1
    for d in n.shape:
        size *= int(d)
    return size
