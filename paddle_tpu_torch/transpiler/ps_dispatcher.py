"""Parameter-shard dispatchers: assign sliced variable blocks to endpoints
(the JAX package's transpiler/ps_dispatcher.py).

Reference analog: python/paddle/fluid/transpiler/ps_dispatcher.py (PSDispatcher,
RoundRobin, HashName). Endpoints name parameter-shard owners: a "pserver"
here is the host process owning a shard of the parameter / optimizer state
(see distribute_transpiler.py), and the dispatch policy layer is the
reference's. HashName hashes with Python's hash(), which varies between
processes unless PYTHONHASHSEED is set: every process of a cluster must
agree, as in the reference.
"""

__all__ = ["PSDispatcher", "RoundRobin", "HashName"]


class PSDispatcher:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class HashName(PSDispatcher):
    """Hash(var name) % #endpoints (reference ps_dispatcher.py:HashName)."""

    def _hash_block(self, block_str, total):
        return hash(block_str) % total

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server_id = self._hash_block(var.name(), len(self._eps))
            eplist.append(self._eps[server_id])
        return eplist


class RoundRobin(PSDispatcher):
    """Cycle through endpoints (reference ps_dispatcher.py:RoundRobin)."""

    def dispatch(self, varlist):
        eplist = []
        for _ in varlist:
            eplist.append(self._eps[self._step])
            self._step = (self._step + 1) % len(self._eps)
        return eplist
