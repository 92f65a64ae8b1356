"""Process groups and collectives over ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/collective.py``. There a group
is a named mesh axis and an eager collective takes the stacked per-rank
view (``[nranks, ...]``, row ``r`` rank ``r``'s tensor) on one
controller. Here every rank is its own process: each op takes the
rank's own tensor and returns the rank's own result, row ``r`` of the
JAX eager op's stacked result on the stacked inputs. A :class:`Group`
wraps a ``torch.distributed`` process group (gloo on the CPU, NCCL on
the card; ``parallel.init_parallel_env``); a mesh axis of one rank, or
any group while no process group exists, makes every op the identity.
The world group of a one-rank world that started a process group still
calls it (real NCCL calls on one card).

- ``all_reduce`` (SUM / MAX / MIN / PROD / AVG) and ``broadcast`` work
  in place and return the tensor; AVG is a SUM divided by the group's
  size (gloo has no AVG).
- ``all_gather(x)`` returns the ``[nranks, ...]`` stack;
  ``all_gather(list, x)`` appends each rank's tensor to the list.
- ``reduce`` leaves the reduction on ``dst`` and every other rank's
  tensor as it was; ``scatter`` gives each rank its row of ``src``'s
  list; ``alltoall`` takes the
  ``[nranks, ...]`` blocks a rank sends (block ``d`` to rank ``d``) and
  returns the blocks it received (block ``s`` from rank ``s``); on a
  tensor that requires grad it is an autograd node whose backward is
  the inverse exchange (the same all-to-all of the gradients), on any
  backend and route.
- ``send`` / ``recv`` pair across processes, matched by ``tag`` as
  well as by peer; ``isend`` / ``irecv`` post them and return a
  :class:`P2PWork` to ``wait()`` on; ``ppermute_shift`` moves each
  rank's tensor to rank ``(r + shift) % n`` as one batch of ``isend`` /
  ``irecv``. The pipeline's stage handoff is made of these.

Every op runs through :func:`_run_collective` (the
``FLAGS_collective_timeout_s`` watchdog and the chaos site
``collective.hang``) inside :func:`_comm_trace`, which writes the
``comm_ops_total``, ``comm_bytes_total`` and ``comm_latency_seconds``
series (``comm_cold_dispatch_seconds`` for a group's first call of an
op, which sets up its communicator), a ``collective::<op>`` span under
an active trace, a ``comm::<op>`` ``RecordEvent`` and, with the flight
recorder on, a ``collective`` event. The latency is the host's: the
call's return (gloo and a blocking NCCL call included), not the card's
completion.

Which ops a backend takes on CUDA tensors differs: gloo has no
reduce-scatter or all-to-all over them, so the port builds what it
needs from ``all_reduce``, ``all_gather`` and ``broadcast``, which
gloo and NCCL both take (``alltoall`` over gloo on CUDA tensors goes
through an ``all_gather``). gloo's point-to-point ops move host memory
only, so on the gloo backend a CUDA tensor's ``send``, ``recv``,
``isend``, ``irecv`` and ``ppermute_shift`` always go through a pinned
host buffer: one device-to-host copy before the send, one host-to-device
copy after the receive (:func:`p2p_route` names the route).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Sequence

import torch

from ..testing import chaos
from . import env

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "destroy_process_group",
    "all_reduce", "all_gather", "all_gather_object", "reduce", "broadcast",
    "scatter", "alltoall", "send", "recv", "isend", "irecv", "P2PWork",
    "p2p_route", "barrier", "wait",
    "all_reduce_arrays", "ppermute_shift", "is_initialized",
    "get_world_size_of_group", "CollectiveTimeoutError",
]


class CollectiveTimeoutError(RuntimeError):
    """A collective did not return within ``FLAGS_collective_timeout_s``
    (the JAX package's error, an NCCL watchdog abort's analogue): it
    carries the op, the group's axis and the budget. The stuck call's
    thread is abandoned; recovery is a restart from the last
    checkpoint."""

    def __init__(self, op: str, group: "Group", timeout_s: float):
        super().__init__(
            f"collective {op!r} on group {group.axis_name!r} "
            f"(nranks={group.nranks}) did not complete within "
            f"{timeout_s:g}s (FLAGS_collective_timeout_s). The dispatch "
            "thread is abandoned; on a real hang, restart from the last "
            "committed checkpoint.")
        self.op = op
        self.group_axis = group.axis_name
        self.timeout_s = timeout_s


class ReduceOp:
    """The JAX package's codes (SUM/MAX/MIN/PROD/AVG)."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _torch_op(op: int):
    import torch.distributed as dist
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


class Group:
    """A communicator: its global ranks, an id, an axis name and the
    ``torch.distributed`` process group (None for a group of one rank,
    or before a process group exists)."""

    def __init__(self, ranks: Sequence[int], gid: int,
                 axis_name: Optional[str] = None, process_group=None):
        self.ranks = list(ranks)
        self.id = gid
        self.axis_name = axis_name or f"group_{gid}"
        self.process_group = process_group

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 if not a member)."""
        return self.get_group_rank(env.get_rank())

    def get_group_rank(self, global_rank: int) -> int:
        return (self.ranks.index(global_rank) if global_rank in self.ranks
                else -1)

    def is_member(self) -> bool:
        return env.get_rank() in self.ranks

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name!r}, "
                f"ranks={self.ranks})")


_lock = threading.Lock()
_groups: dict = {}
_next_gid = [1]  # gid 0 is the world group
_warm: set = set()


def _pg_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _default_group() -> Group:
    with _lock:
        g = _groups.get(0)
        n = env.get_world_size() if _pg_ready() else 1
        if g is None or g.nranks != n:
            pg = None
            if _pg_ready():
                import torch.distributed as dist
                pg = dist.group.WORLD
            g = _groups[0] = Group(list(range(n)), 0, "world", pg)
    return g


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None, timeout=None,
              axis_name: Optional[str] = None) -> Group:
    """A communicator over ``ranks`` (default: every rank). As with
    ``torch.distributed.new_group``, every process of the world must
    call it, members or not, in the same order."""
    world = env.get_world_size() if _pg_ready() else 1
    ranks = sorted(range(world) if ranks is None else ranks)
    pg = None
    if _pg_ready() and world > 1:
        import torch.distributed as dist
        kw = {"backend": backend} if backend else {}
        if timeout is not None:
            kw["timeout"] = timeout
        # a group of one rank still goes through new_group, which every
        # rank must call; its ops never touch it
        pg = dist.new_group(ranks, **kw)
    with _lock:
        gid = _next_gid[0]
        _next_gid[0] += 1
        g = Group(ranks, gid, axis_name,
                  pg if len(ranks) > 1 else None)
        _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _default_group()
    return _groups[gid]


def destroy_process_group(group: Optional[Group] = None) -> None:
    """Forget ``group``; with None forget every group and destroy the
    default process group (the gid counter stays monotonic, so gid 0
    is only ever the world)."""
    with _lock:
        if group is not None:
            _groups.pop(group.id, None)
            return
        _groups.clear()
        _warm.clear()
    if _pg_ready():
        import torch.distributed as dist
        dist.destroy_process_group()
    env.reset()


def is_initialized() -> bool:
    """Whether a ``torch.distributed`` process group exists."""
    return _pg_ready()


def get_world_size_of_group(group: Optional[Group] = None) -> int:
    return (group or _default_group()).nranks


# ---------------------------------------------------------------------------
# telemetry and the watchdog
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _comm_trace(op: str, group: Group, x):
    """The JAX package's comm observability (``collective.py:248``): the
    ``comm_*`` series, a ``collective::<op>`` span, a ``comm::<op>``
    RecordEvent and a flight ``collective`` event. Telemetry never sinks
    the collective."""
    nbytes = int(x.numel() * x.element_size()) \
        if isinstance(x, torch.Tensor) else 0
    key = (group.id, group.axis_name, group.nranks, op)
    warm = key in _warm
    _warm.add(key)
    try:
        from ..profiler import RecordEvent
        span = RecordEvent(f"comm::{op}")
    except Exception:
        span = contextlib.nullcontext()
    try:
        from ..monitor import trace as _trace
        tspan = _trace.maybe_span(f"collective::{op}",
                                  group=group.axis_name,
                                  nranks=group.nranks, bytes=nbytes)
    except Exception:
        tspan = contextlib.nullcontext()
    t0 = time.perf_counter()
    with span, tspan:
        yield
    dt = time.perf_counter() - t0
    try:
        from ..monitor import get_registry
        reg = get_registry()
        labels = {"op": op, "group": group.axis_name,
                  "nranks": group.nranks}
        reg.counter("comm_ops_total",
                    "eager collective dispatches").inc(**labels)
        reg.counter("comm_bytes_total",
                    "operand bytes moved through eager collectives"
                    ).inc(nbytes, **labels)
        reg.histogram("comm_latency_seconds" if warm
                      else "comm_cold_dispatch_seconds",
                      "eager collective dispatch latency (warm wrapper)"
                      if warm else
                      "first-call eager collective dispatch incl. "
                      "trace+compile").observe(dt, **labels)
        from ..monitor import flight_recorder as _flight
        if _flight.enabled():
            _flight.get_flight_recorder().record_event(
                "collective", op=op, group=group.axis_name,
                nranks=group.nranks, bytes=nbytes, dispatch_ms=dt * 1e3)
    except Exception:
        pass


def _run_collective(op: str, group: Group, fn, *args):
    """Run a collective under the watchdog, as the JAX package does
    (``collective.py:314-383``): a direct call with
    ``FLAGS_collective_timeout_s`` unset and no chaos armed; with a
    budget, the call runs on a daemon thread and a stall past it raises
    :class:`CollectiveTimeoutError` (a ``collective_timeouts_total``
    count and a ``collective_timeout`` flight event). The chaos site
    ``collective.hang`` blocks that thread (bounded, cancellable) before
    the collective; once abandoned, the thread returns without starting
    it."""
    from ..core.flags import get_flag
    timeout_s = float(get_flag("collective_timeout_s") or 0.0)
    hang = chaos.active() and chaos.probe("collective.hang")
    if timeout_s <= 0.0 and not hang:
        return fn(*args)
    if hang and timeout_s <= 0.0:
        raise RuntimeError(
            "chaos site 'collective.hang' fired but "
            "FLAGS_collective_timeout_s is unset — set a timeout budget "
            "so the watchdog (the thing this site exists to exercise) "
            "can convert the hang into CollectiveTimeoutError")
    result: dict = {}
    done = threading.Event()
    abandoned = threading.Event()

    def worker():
        try:
            if hang:
                chaos.hang_loop(max(timeout_s, 1.0) * 20 + 60.0)
            # a call abandoned before it reached the collective never
            # starts it, so the ranks' later collectives stay matched
            if abandoned.is_set():
                return
            result["value"] = fn(*args)
        except BaseException as e:     # surfaces on the caller's thread
            result["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True,
                         name=f"collective-{op}")
    t.start()
    if not done.wait(timeout_s):
        abandoned.set()
        try:
            from ..monitor import get_registry
            get_registry().counter(
                "collective_timeouts_total",
                "eager collective watchdog trips").inc(
                    op=op, group=group.axis_name)
        except Exception:
            pass
        try:
            from ..monitor import flight_recorder as _flight
            if _flight.enabled():
                _flight.get_flight_recorder().record_event(
                    "collective_timeout", op=op, group=group.axis_name,
                    nranks=group.nranks, timeout_s=timeout_s)
        except Exception:
            pass
        raise CollectiveTimeoutError(op, group, timeout_s)
    if "error" in result:
        raise result["error"]
    return result["value"]


def _collective(op: str, group: Group, x, fn, *args):
    with _comm_trace(op, group, x):
        return _run_collective(op, group, fn, *args)


def _backend(group: Group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group.process_group)).lower()


# ---------------------------------------------------------------------------
# the collectives: each rank's own tensor in, its own result out
# ---------------------------------------------------------------------------

def all_reduce(tensor, op: int = ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True, use_calc_stream: bool = False):
    """Reduce ``tensor`` over the group in place; returns it."""
    g = group or _default_group()
    if g.process_group is None:
        return tensor

    def run():
        import torch.distributed as dist
        dist.all_reduce(tensor, _torch_op(op), group=g.process_group)
        if op == ReduceOp.AVG:
            tensor.div_(g.nranks)
        return tensor
    return _collective("all_reduce", g, tensor, run)


def all_gather(tensor_or_list, tensor=None, group: Optional[Group] = None,
               sync_op: bool = True, axis: int = 0):
    """``all_gather(x)``: the ``[nranks, ...]`` stack of every rank's
    ``x``. ``all_gather(tensor_list, x)``: append each rank's tensor to
    ``tensor_list``."""
    g = group or _default_group()
    if tensor is None:
        x = tensor_or_list
        if g.process_group is None:
            return x.unsqueeze(0)
        return torch.stack(_gather_list(g, x))
    tensor_list, x = tensor_or_list, tensor
    if g.process_group is None:
        tensor_list.append(x)
        return None
    tensor_list.extend(_gather_list(g, x))
    return None


def _gather_list(g: Group, x) -> List[torch.Tensor]:
    x = x.contiguous()

    def run():
        import torch.distributed as dist
        out = [torch.empty_like(x) for _ in range(g.nranks)]
        dist.all_gather(out, x, group=g.process_group)
        return out
    return _collective("all_gather", g, x, run)


def all_gather_object(obj_list: List, obj, group: Optional[Group] = None):
    """Append every rank's picklable ``obj`` to ``obj_list``."""
    g = group or _default_group()
    if g.process_group is None:
        obj_list.append(obj)
        return

    def run():
        import torch.distributed as dist
        out = [None] * g.nranks
        dist.all_gather_object(out, obj, group=g.process_group)
        return out
    obj_list.extend(_collective("all_gather_object", g, None, run))


def reduce(tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """The reduction lands in ``dst``'s tensor (a global rank); every
    other rank's tensor stays as it was. Returns the tensor."""
    g = group or _default_group()
    if g.process_group is None:
        return tensor

    def run():
        import torch.distributed as dist
        red = tensor.clone()
        dist.all_reduce(red, _torch_op(op), group=g.process_group)
        if env.get_rank() == dst:
            tensor.copy_(red.div_(g.nranks) if op == ReduceOp.AVG else red)
        return tensor
    return _collective("reduce", g, tensor, run)


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True):
    """Every rank's tensor takes ``src``'s (a global rank), in place."""
    g = group or _default_group()
    if g.process_group is None:
        return tensor

    def run():
        import torch.distributed as dist
        dist.broadcast(tensor, src, group=g.process_group)
        return tensor
    return _collective("broadcast", g, tensor, run)


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """Rank ``r`` of the group receives row ``r`` of ``src``'s
    ``tensor_list`` into ``tensor`` (in place; ``tensor_list`` is read on
    ``src`` only): row ``r`` of the JAX op's stacked view. Returns
    ``tensor``."""
    g = group or _default_group()
    if g.process_group is None:
        if tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    if env.get_rank() == src:
        stacked = torch.stack(list(tensor_list)).contiguous()
    else:
        stacked = torch.empty((g.nranks,) + tuple(tensor.shape),
                              dtype=tensor.dtype, device=tensor.device)
    broadcast(stacked, src, g)
    tensor.copy_(stacked[g.rank])
    return tensor


class _AllToAll(torch.autograd.Function):
    """The exchange as an autograd node: block ``d`` of a rank's
    gradient goes back to rank ``d``, the same all-to-all on the
    cotangents (the exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _alltoall(x, group)

    @staticmethod
    def backward(ctx, g):
        return _alltoall(g.contiguous(), ctx.group), None


def alltoall(in_tensor_list, out_tensor_list=None,
             group: Optional[Group] = None, sync_op: bool = True):
    """This rank sends block ``d`` of ``in_tensor_list`` (a list, or a
    ``[nranks, ...]`` tensor) to rank ``d`` and receives block ``s`` of
    its result from rank ``s``. With a list in, the list of received
    blocks (appended to ``out_tensor_list`` when given). Differentiable:
    a tensor that requires grad gets the received blocks' gradient back
    by the inverse exchange (the expert all-to-all of
    ``incubate.moe``)."""
    g = group or _default_group()
    as_list = isinstance(in_tensor_list, (list, tuple))
    x = torch.stack(list(in_tensor_list)) if as_list else in_tensor_list
    if x.shape[0] != g.nranks:
        raise ValueError(f"alltoall: expected {g.nranks} blocks, got "
                         f"{x.shape[0]}")
    if (g.process_group is not None and torch.is_grad_enabled()
            and x.requires_grad):
        out = _AllToAll.apply(x, g)
    else:
        out = _alltoall(x, g)
    if not as_list:
        return out
    res = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(res)
        return None
    return res


def _alltoall(x, g: Group) -> torch.Tensor:
    """The ``[nranks, ...]`` exchange of :func:`alltoall`, no autograd."""
    if g.process_group is None:
        out = x
    elif x.is_cuda and _backend(g) == "gloo":
        # gloo takes no all-to-all over CUDA tensors: gather every
        # rank's blocks and keep the ones sent here
        out = all_gather(x.contiguous(), group=g)[:, g.rank].contiguous()
    else:
        x = x.contiguous()

        def run():
            import torch.distributed as dist
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=g.process_group)
            return out
        out = _collective("all_to_all", g, x, run)
    return out


def p2p_route(tensor, group: Optional[Group] = None) -> str:
    """How a point-to-point op moves ``tensor`` over ``group``:
    ``"pinned_host"`` for a CUDA tensor on the gloo backend (gloo reads
    and writes host memory only), ``"direct"`` otherwise."""
    g = group or _default_group()
    if (isinstance(tensor, torch.Tensor) and tensor.is_cuda
            and g.process_group is not None and _backend(g) == "gloo"):
        return "pinned_host"
    return "direct"


def _staged(tensor, route: str) -> torch.Tensor:
    """What the backend reads for a send: ``tensor`` itself, or its copy
    in a pinned host buffer (the copy completes before this returns)."""
    if route == "direct":
        return tensor.contiguous()
    buf = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    buf.copy_(tensor)
    return buf


def _landing(tensor, route: str) -> torch.Tensor:
    """Where the backend writes a receive: ``tensor``, or a pinned host
    buffer of its shape that :func:`_land` copies in after."""
    if route == "direct":
        return tensor
    return torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)


def _land(tensor, buf) -> None:
    if buf is not tensor:
        tensor.copy_(buf, non_blocking=True)


class P2PWork:
    """A posted ``isend`` or ``irecv``: ``wait()`` blocks until it is
    done (a receive then holds its data in the tensor it was given) and
    returns that tensor. The staging buffer lives as long as the work."""

    def __init__(self, op: str, group: Group, tensor, buf, work):
        self._op, self._group = op, group
        self._tensor, self._buf, self._work = tensor, buf, work
        self.done = work is None

    def wait(self):
        if not self.done:
            def run():
                self._work.wait()
                if self._op == "irecv":
                    _land(self._tensor, self._buf)
            _collective(f"{self._op}_wait", self._group, self._tensor, run)
            self.done = True
            self._buf = self._work = None
        return self._tensor


def send(tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True, tag: int = 0):
    """Send ``tensor`` to global rank ``dst``; a matching :func:`recv`
    on ``dst`` (same ``tag``) receives it."""
    g = group or _default_group()
    route = p2p_route(tensor, g)

    def run():
        import torch.distributed as dist
        dist.send(_staged(tensor, route), dst, group=g.process_group,
                  tag=tag)
        return tensor
    return _collective("send", g, tensor, run)


def recv(tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True, tag: int = 0):
    """Receive into ``tensor`` (in place) what global rank ``src`` sent
    with the same ``tag``."""
    g = group or _default_group()
    route = p2p_route(tensor, g)

    def run():
        import torch.distributed as dist
        buf = _landing(tensor, route)
        dist.recv(buf, src, group=g.process_group, tag=tag)
        _land(tensor, buf)
        return tensor
    return _collective("recv", g, tensor, run)


def isend(tensor, dst: int = 0, group: Optional[Group] = None,
          tag: int = 0) -> P2PWork:
    """Post a send of ``tensor`` to global rank ``dst``; the returned
    work's ``wait()`` blocks until the receiver has it. On the pinned
    route the data is copied out before this returns, so ``tensor`` may
    change at once."""
    g = group or _default_group()
    route = p2p_route(tensor, g)

    def run():
        import torch.distributed as dist
        buf = _staged(tensor, route)
        return P2PWork("isend", g, tensor, buf, dist.isend(
            buf, dst, group=g.process_group, tag=tag))
    return _collective("isend", g, tensor, run)


def irecv(tensor, src: int = 0, group: Optional[Group] = None,
          tag: int = 0) -> P2PWork:
    """Post a receive into ``tensor`` from global rank ``src``; its data
    is there once the returned work's ``wait()`` returns."""
    g = group or _default_group()
    route = p2p_route(tensor, g)

    def run():
        import torch.distributed as dist
        buf = _landing(tensor, route)
        return P2PWork("irecv", g, tensor, buf, dist.irecv(
            buf, src, group=g.process_group, tag=tag))
    return _collective("irecv", g, tensor, run)


def ppermute_shift(x, group: Optional[Group] = None, shift: int = 1):
    """Ring shift: group rank ``r``'s tensor moves to rank
    ``(r + shift) % n``; returns what this rank received (the JAX
    ``ppermute`` of the pipeline stages), one ``batch_isend_irecv``."""
    g = group or _default_group()
    n = g.nranks
    if n == 1 or g.process_group is None or shift % n == 0:
        return x
    x = x.contiguous()
    me = g.rank
    to = g.ranks[(me + shift) % n]
    frm = g.ranks[(me - shift) % n]
    route = p2p_route(x, g)

    def run():
        import torch.distributed as dist
        out = torch.empty_like(x)
        buf = _landing(out, route)
        ops = [dist.P2POp(dist.isend, _staged(x, route), to,
                          g.process_group),
               dist.P2POp(dist.irecv, buf, frm, g.process_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _land(out, buf)
        return out
    return _collective("ppermute_shift", g, x, run)


def barrier(group: Optional[Group] = None) -> None:
    g = group or _default_group()
    if g.process_group is None:
        return

    def run():
        import torch.distributed as dist
        dist.barrier(group=g.process_group)
    _collective("barrier", g, None, run)


def wait(tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True):
    """Block the host until ``tensor``'s pending work on its device is
    done (the card's current stream); returns it."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def all_reduce_arrays(arrays: List, op: int = ReduceOp.SUM,
                      group: Optional[Group] = None) -> List:
    """Reduce each of this rank's tensors over the group; returns new
    tensors (``DataParallel.apply_collective_grads``'s helper)."""
    return [all_reduce(torch.as_tensor(a).clone(), op, group)
            for a in arrays]
