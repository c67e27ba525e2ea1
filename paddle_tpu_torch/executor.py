"""Executor: runs a block's ops as torch calls on one device (the torch
counterpart of paddle_tpu/executor.py).

Where the JAX package traces a whole block into one jitted XLA computation,
this executor interprets the block straight-line (the reference's
Executor::RunPreparedContext loop, executor.cc:389-396): each op's lowering
is one or a few eager torch calls on the executor's device.

State model: a Scope holds name -> torch.Tensor on one device. Persistable
vars the block reads are state; those it also writes (parameters written by
a startup program, KV pools written by kv_cache_write) come back as updated
state. A lowering may update a state tensor in place (kv_cache_write does),
which is the torch form of the JAX package's donated buffers.

Placement: Executor and Scope take the card (CUDAPlace(0)) unless given a
place; with no CUDA device and no explicit CPUPlace() they raise.
"""

import itertools
import threading

import numpy as np
import torch

from . import framework
from .framework import Variable
from .ops import registry
from .ops.registry import EMPTY_VAR_NAME
from .place import to_device

__all__ = [
    "Executor",
    "Scope",
    "global_scope",
    "scope_guard",
    "aot_serve_lowering",
]


class Scope:
    """name -> device tensor store (reference scope.h:134, flat) on one
    device, plus the torch.Generators that random ops draw from."""

    _uid_counter = itertools.count()

    def __init__(self, seed=0, place=None):
        self.device = to_device(place)
        self.vars = {}
        self._seed = seed
        self._generator = None  # lazy, like the JAX package's rng key
        self._device_generator = None
        self._uid = next(Scope._uid_counter)

    @property
    def generator(self):
        """CPU torch.Generator seeded from the scope seed: random init draws
        on the host, so a seed gives the same parameters on every device."""
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(int(self._seed))
        return self._generator

    @generator.setter
    def generator(self, value):
        self._generator = value

    @property
    def device_generator(self):
        """torch.Generator on the scope's device, seeded from the scope
        seed: stochastic ops of a training step (dropout) draw their masks
        on the device, with no host round trip."""
        if self._device_generator is None:
            self._device_generator = torch.Generator(device=self.device).manual_seed(
                int(self._seed)
            )
        return self._device_generator

    def reseed(self, seed):
        """Restart both generators from `seed` (an explicit
        program.random_seed, as the JAX package rekeys its rng)."""
        self._seed = int(seed)
        self._generator = self._device_generator = None

    def find_var(self, name):
        return self.vars.get(name)

    def var_names(self):
        """reference scope.h LocalVarNames()"""
        return list(self.vars)

    def var(self, name):
        return self.vars.setdefault(name, None)

    def set_var(self, name, value):
        self.vars[name] = value


_global_scope = None
_scope_tls = threading.local()


def _scope_stack():
    st = getattr(_scope_tls, "stack", None)
    if st is None:
        st = _scope_tls.stack = []
    return st


def global_scope():
    """The innermost scope_guard's scope, else the process scope (created on
    first use, on the card)."""
    global _global_scope
    st = _scope_stack()
    if st:
        return st[-1]
    if _global_scope is None:
        _global_scope = Scope()
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack().append(self.scope)

    def __exit__(self, *args):
        _scope_stack().pop()


def _var_dtype(block, name):
    v = block.vars.get(name)
    if v is None and block.has_var_recursive(name):
        v = block._var_recursive(name)
    if v is None or v.dtype is None:
        return None
    return registry.torch_dtype(v.dtype)


def to_tensor(value, device, dtype=None):
    """A feed value (numpy array, scalar or tensor) as a tensor on `device`
    with `dtype` (the declared var dtype), copying only when needed."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        value = torch.from_numpy(np.ascontiguousarray(arr))
    return value.to(device=device, dtype=dtype)


def _apply_pass_pipeline(program, scope, feed_names, fetch_names, pipeline=None):
    """The single choke point where graph passes rewrite a program before it
    runs (paddle_tpu_torch/passes). `pipeline` None defers to
    FLAGS_pass_pipeline; ""/"off"/() returns the program untouched. The
    rewritten program is memoized per (program version, pipeline, scope,
    feed/fetch), so repeated runs hand the executor the SAME object and its
    block cache stays hot."""
    if pipeline is None:
        from . import flags as _flags

        pipeline = _flags.get_flags("pass_pipeline")["pass_pipeline"]
    from .passes import manager as _pm

    if not _pm.resolve_pipeline(pipeline):
        return program
    return _pm.apply_cached(
        program, pipeline, scope=scope,
        feed_names=feed_names, fetch_names=fetch_names,
    )


class _CompiledBlock:
    """A block prepared for straight-line execution: the op list, the state
    split (read-only vs written persistables), the persistables the block
    creates, and the declared feed dtypes."""

    def __init__(self, block, feed_names, fetch_names, scope):
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        unknown = sorted(
            {op.type for op in block.ops if not registry.is_registered(op.type)}
        )
        if unknown:
            raise NotImplementedError("ops without lowering: %s" % unknown)
        self.ops = [op for op in block.ops if not registry.get(op.type).skip_exec]

        # classify external inputs: fed names are args; persistable names found
        # in the scope are state; anything else must be produced by the block
        produced = set()
        state_names = []
        fed = set(self.feed_names)
        for op in self.ops:
            for name in op.input_arg_names:
                if name == EMPTY_VAR_NAME:
                    continue
                if name in fed or name in produced or name in state_names:
                    continue
                if scope.find_var(name) is not None:
                    state_names.append(name)
                else:
                    raise RuntimeError(
                        "variable %r used by op %s is neither fed, in scope, nor "
                        "produced earlier in the block" % (name, op)
                    )
            produced.update(n for n in op.output_arg_names if n != EMPTY_VAR_NAME)
        for name in self.fetch_names:
            if name not in fed and name not in produced and name not in state_names:
                if scope.find_var(name) is not None:
                    state_names.append(name)
                else:
                    raise RuntimeError("fetch var %r has no value" % name)

        persistable = {
            name
            for name in state_names + list(produced)
            if block.has_var_recursive(name) and block._var_recursive(name).persistable
        }
        self.mut_names = sorted(set(state_names) & produced)
        self.ro_names = sorted(set(state_names) - produced)
        self.created_persistables = sorted((persistable & produced) - set(state_names) - fed)
        self.feed_dtypes = {n: _var_dtype(block, n) for n in self.feed_names}

        # cross-check against the inplace_donation_plan pass when one rode in
        # on this program AND it analyzed this exact run (same scope, feed,
        # fetch, nothing unanalyzable): divergence means a pass corrupted
        # def-use, so fail loudly
        plan = getattr(block.program, "_donation_plan", None)
        if (
            plan
            and not plan.get("unknown")
            and plan.get("scope_uid") == scope._uid
            and plan.get("feed") == sorted(self.feed_names)
            and list(plan.get("fetch", ())) == list(self.fetch_names)
            and (plan["mut"] != self.mut_names or plan["ro"] != self.ro_names)
        ):
            raise RuntimeError(
                "inplace_donation_plan disagrees with the block's state "
                "classification: plan mut=%s ro=%s vs mut=%s ro=%s — a pass "
                "likely corrupted def-use edges"
                % (plan["mut"], plan["ro"], self.mut_names, self.ro_names)
            )

    def fn(self, feeds, ro_state, mut_state, ctx):
        """Run the block: (fetches, new_mut, created). `feeds` are tensors on
        ctx.device in their declared dtypes."""
        env = {}
        env.update(ro_state)
        env.update(mut_state)
        env.update(feeds)
        registry.lower_ops(ctx, self.ops, env)
        fetches = [env[n] for n in self.fetch_names]
        new_mut = {n: env[n] for n in self.mut_names}
        # an op may legally omit a declared output slot — only bind names
        # that actually materialized
        created = {n: env[n] for n in self.created_persistables if n in env}
        return fetches, new_mut, created

    def cast_feeds(self, feeds, device):
        return {
            n: to_tensor(v, device, self.feed_dtypes.get(n)) for n, v in feeds.items()
        }

    def __call__(self, scope, feeds):
        ro = {n: scope.vars[n] for n in self.ro_names}
        mut = {n: scope.vars[n] for n in self.mut_names}
        ctx = registry.LowerCtx(
            scope.device, generator=scope.generator,
            device_generator=scope.device_generator,
        )
        fetches, new_mut, created = self.fn(
            self.cast_feeds(feeds, scope.device), ro, mut, ctx
        )
        scope.vars.update(new_mut)
        scope.vars.update(created)
        return fetches


def aot_serve_lowering(program, feed_names, fetch_names, scope,
                       pass_pipeline=None, return_state=False):
    """Forward lowering for serving: returns (serve, ro, mut) where
    `serve(feeds, ro, mut) -> [fetches]` runs the block over the scope's
    read-only / block-written persistables, passed as ARGUMENTS so one
    callable serves any parameter values of the same shapes. Feeds may be
    numpy arrays or tensors; they are cast to the declared dtypes on the
    scope's device.

    `return_state=True` is the decode-state mode: `serve(...) ->
    ([fetches], new_mut)`. kv_cache_write updates the pools in place, so
    new_mut holds the same tensors the caller passed in.

    The JAX package runs its "inference" pass preset here; the port's
    serving path lowers the Program verbatim (the preset's fold/DCE/fusion
    tagging do not change the math). Any pipeline other than
    None/""/"off"/"inference" raises."""
    if pass_pipeline not in (None, "", "off", "inference"):
        raise NotImplementedError(
            "pass pipeline %r: the pass framework is not ported yet" % (pass_pipeline,)
        )
    compiled = _CompiledBlock(
        program.global_block(), list(feed_names), list(fetch_names), scope
    )
    ro = {n: scope.vars[n] for n in compiled.ro_names}
    mut = {n: scope.vars[n] for n in compiled.mut_names}
    device = scope.device

    def run(feeds, ro_, mut_):
        # inference programs are pruned of stochastic ops, so the generator
        # is never drawn from here
        ctx = registry.LowerCtx(device, generator=scope.generator, is_test=True)
        fetches, new_mut, _ = compiled.fn(
            compiled.cast_feeds(feeds, device), ro_, mut_, ctx
        )
        return fetches, new_mut

    if return_state:
        return run, ro, mut

    def serve(feeds, ro_, mut_):
        return run(feeds, ro_, mut_)[0]

    return serve, ro, mut


class Executor:
    """Drop-in for fluid.Executor (reference python/paddle/fluid/executor.py:256)
    on one torch device: `place` None means CUDAPlace(0)."""

    def __init__(self, place=None):
        self.place = place
        self.device = to_device(place)
        self._cache = {}

    def close(self):
        self._cache.clear()

    def run(
        self,
        program=None,
        feed=None,
        fetch_list=None,
        feed_var_name="feed",
        fetch_var_name="fetch",
        scope=None,
        return_numpy=True,
        use_program_cache=True,
    ):
        if program is None:
            program = framework.default_main_program()
        feed = dict(feed or {})
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        if scope.device != self.device:
            raise ValueError(
                "scope lives on %s but the executor runs on %s"
                % (scope.device, self.device)
            )
        # an explicit program.random_seed reseeds the scope's generators
        # once, like the JAX package's rng key
        if program.random_seed and not getattr(scope, "_seeded", False):
            scope.reseed(program.random_seed)
            scope._seeded = True
        fetch_names = [
            f.name if isinstance(f, Variable) else str(f) for f in fetch_list
        ]
        # graph-pass choke point: FLAGS_pass_pipeline rewrites the program
        # here, before the block below is prepared; the cache keys on the
        # (memoized) rewritten program
        program = _apply_pass_pipeline(program, scope, list(feed), fetch_names)
        block = program.global_block()
        key = (
            program._uid,
            program._version,
            tuple(sorted(feed)),
            tuple(fetch_names),
            scope._uid,
        )
        compiled = self._cache.get(key) if use_program_cache else None
        if compiled is None:
            compiled = _CompiledBlock(block, list(feed), fetch_names, scope)
            if use_program_cache:
                self._cache[key] = compiled
        fetches = compiled(scope, feed)
        if return_numpy:
            # copies: a fetched CPU tensor may be state that a later step
            # updates in place (the fused Adam does)
            return [f.detach().to("cpu", copy=True).numpy() for f in fetches]
        return fetches

    @staticmethod
    def stats():
        """Kernel counters of the training path: `dispatches`, the runs each
        fused family took (ops/fused.py, the JAX package's
        KERNEL_DISPATCHES), and `launches`, the hand-written kernels each
        wrapper launched on the card (a CPU run takes the plain versions
        and launches none)."""
        from .ops import fused

        return fused.stats()
