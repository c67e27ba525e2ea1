"""Shared-memory ring buffer of fixed-size batch slabs.

Reference analog: operators/reader/lod_tensor_blocking_queue.h — the native
bounded queue decode threads filled while the trainer popped. That queue
lived in one C++ process; here the decode workers are PROCESSES (Python
parse/augment code does not scale across threads under the GIL), so the
hand-off memory is ``multiprocessing.shared_memory``: one segment per ring
slot, sized for one packed batch. Workers write decoded arrays directly
into a slab the trainer process has mapped — the array payload crosses the
process boundary with zero pickling and zero extra copies; only a tiny
descriptor (slot index, field shapes/dtypes/offsets, seq) travels over a
queue.

Slot life cycle (single-writer-per-slot discipline):

    free -> claimed by one worker -> begin_write (seq EVEN->ODD, owner=wid)
         -> payload memcpy into slab -> commit (seq ODD->EVEN)
         -> descriptor to the trainer -> trainer copies out -> release(free)

The per-slot uint64 ``seq`` is a seqlock-style ready flag: ODD means a
write is in flight, EVEN means stable, and the committed value rides the
descriptor so the consumer can verify the slab is exactly the write the
descriptor announced (before AND after its copy-out). A worker that dies
mid-write leaves its slot ODD with its owner id in the control block;
``reclaim_dead`` bumps such slots back to EVEN so the supervisor can return
them to the free pool — the half-written payload can never be served
because no descriptor carries the new seq.

Aligned 8-byte loads/stores are atomic on x86-64 and aarch64, and each seq
cell has exactly one writer at a time, so no cross-process lock is needed
on the hot path.

Dtypes: every field is a plain numpy dtype. A bf16 field travels as uint16
(the upper half of the f32 value after round-to-nearest-even, py_reader's
wire form) and becomes torch.bfloat16 by a view once staged, so no process
needs an extension dtype.
"""

import os
import struct

import numpy as np

__all__ = ["RingBuffer", "TornSlotError", "SlabOverflowError"]

_MAGIC = 0x70746472  # 'ptdr'


class TornSlotError(RuntimeError):
    """Slab content no longer matches the descriptor's committed seq —
    the protocol was violated (or a reclaimed slot raced); the batch must
    be dropped, never served."""


class SlabOverflowError(ValueError):
    """A packed batch exceeds slot_bytes; raise with the size needed so
    the caller can re-create the ring with bigger slabs."""


def _attach(name):
    """Attach an existing segment WITHOUT resource-tracker registration:
    the creating process owns unlink (bpo-38119). All processes of one
    family share ONE tracker, so an attach-side register/unregister pair
    would strip the creator's registration and spam KeyError tracebacks;
    instead the register call is suppressed for the attach itself."""
    from multiprocessing import resource_tracker, shared_memory

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class RingBuffer:
    """``create=True`` builds the segments (trainer side, owns unlink);
    ``create=False`` attaches by name (worker side)."""

    def __init__(self, slots, slot_bytes, name=None, create=True):
        from multiprocessing import shared_memory

        if create:
            if slots < 1:
                raise ValueError("need at least 1 slot, got %r" % (slots,))
            if slot_bytes < 64:
                raise ValueError("slot_bytes too small: %r" % (slot_bytes,))
            if name is None:
                name = "ptd%x-%s" % (os.getpid() & 0xFFFFFF, os.urandom(3).hex())
        self.name = name
        self.owns = bool(create)
        ctl_name = name + "-ctl"
        # control block: [magic u32, slots u32, slot_bytes u64] header, then
        # per-slot seq (u64) and owner (i32, -1 = unowned)
        hdr = struct.calcsize("<IIQ")
        if create:
            ctl_bytes = hdr + slots * (8 + 4)
            self._ctl = shared_memory.SharedMemory(
                name=ctl_name, create=True, size=ctl_bytes
            )
            struct.pack_into("<IIQ", self._ctl.buf, 0, _MAGIC, slots, slot_bytes)
        else:
            self._ctl = _attach(ctl_name)
            magic, slots, slot_bytes = struct.unpack_from("<IIQ", self._ctl.buf, 0)
            if magic != _MAGIC:
                raise RuntimeError("bad ring control block %r" % (ctl_name,))
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._seq = np.frombuffer(
            self._ctl.buf, dtype=np.uint64, count=self.slots, offset=hdr
        )
        self._owner = np.frombuffer(
            self._ctl.buf,
            dtype=np.int32,
            count=self.slots,
            offset=hdr + self.slots * 8,
        )
        if create:
            self._owner[:] = -1
        self._slabs = []
        for i in range(self.slots):
            seg_name = "%s-s%d" % (name, i)
            if create:
                seg = shared_memory.SharedMemory(
                    name=seg_name, create=True, size=self.slot_bytes
                )
            else:
                seg = _attach(seg_name)
            self._slabs.append(seg)

    # --- writer side (one claiming worker per slot) ---
    def try_claim(self, slot, owner):
        """Lock-free slot claim. Slots are statically partitioned per
        worker (slot s belongs to worker s % num_workers), so for any slot
        there is exactly ONE claimer — the handoff is a plain aligned store:
        the consumer releases by writing owner=-1, the home worker claims by
        writing its id back. No cross-process lock exists to be poisoned by
        a SIGKILL (a mp.Queue of free slots would hold its reader lock for
        the whole get() poll — killing the holder starves every worker)."""
        if int(self._owner[slot]) != -1:
            return False
        self._owner[slot] = np.int32(owner)
        return True

    def begin_write(self, slot, owner):
        self._owner[slot] = np.int32(owner)
        self._seq[slot] += np.uint64(1)  # EVEN -> ODD: write in flight

    def pack(self, slot, feed):
        """memcpy each array of ``feed`` (dict name -> ndarray) into the
        slab, back to back. Returns (meta, nbytes): meta is the descriptor
        payload [(name, shape, dtype_str, offset)] the consumer needs to
        rebuild views — small, picklable, and the ONLY thing that leaves
        this process through a queue."""
        meta = []
        off = 0
        buf = self._slabs[slot].buf
        for name in sorted(feed):
            arr = np.ascontiguousarray(feed[name])
            nb = arr.nbytes
            if off + nb > self.slot_bytes:
                raise SlabOverflowError(
                    "batch needs %d bytes but ring slots hold %d — pass a "
                    "bigger slot_bytes / batch_spec to the runtime"
                    % (off + nb, self.slot_bytes)
                )
            if nb:
                buf[off : off + nb] = arr.reshape(-1).view(np.uint8).data
            meta.append((name, tuple(arr.shape), arr.dtype.str, off))
            off += nb
        return meta, off

    def commit(self, slot):
        self._seq[slot] += np.uint64(1)  # ODD -> EVEN: stable
        return int(self._seq[slot])

    # --- consumer side (trainer process) ---
    def seq(self, slot):
        return int(self._seq[slot])

    def read(self, slot, meta, expect_seq):
        """Copy the packed fields back out as owned ndarrays, verifying the
        seqlock before and after the copy. The copy is deliberate: the
        returned arrays must survive slot reuse, and a CPU tensor made by
        torch.from_numpy aliases its array instead of copying it."""
        s0 = int(self._seq[slot])
        if s0 != expect_seq or s0 % 2 == 1:
            raise TornSlotError(
                "slot %d seq %d != descriptor seq %d" % (slot, s0, expect_seq)
            )
        out = {}
        buf = self._slabs[slot].buf
        for name, shape, dtype_str, off in meta:
            dt = np.dtype(dtype_str)
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            view = np.frombuffer(buf, dtype=dt, count=n, offset=off)
            out[name] = view.reshape(shape).copy()
        s1 = int(self._seq[slot])
        if s1 != s0:
            raise TornSlotError(
                "slot %d overwritten during read (seq %d -> %d)" % (slot, s0, s1)
            )
        return out

    def release(self, slot):
        self._owner[slot] = -1

    def owned_slots(self):
        """Slot indices currently claimed by any worker (mid-write or
        committed-but-undelivered) — the ring-occupancy gauge."""
        return [s for s in range(self.slots) if int(self._owner[s]) != -1]

    # --- supervisor side ---
    def reclaim_dead(self, owner_ids):
        """Slots a dead worker left claimed: ODD seq (mid-write) is bumped
        to the next EVEN value — no descriptor references it, so the torn
        payload is unreachable — and the slot is released so the respawned
        home worker can claim it again. Committed slots whose descriptor
        died with the worker's queue are released the same way (the queue
        is discarded on respawn, so no straggler descriptor can resurface).
        Returns the reclaimed slot indices."""
        owner_ids = set(int(w) for w in owner_ids)
        out = []
        for slot in range(self.slots):
            if int(self._owner[slot]) in owner_ids:
                if int(self._seq[slot]) % 2:
                    self._seq[slot] += np.uint64(1)
                self._owner[slot] = -1
                out.append(slot)
        return out

    def close(self):
        # release numpy views of the mapped buffers before closing the maps
        self._seq = self._owner = None
        for seg in [self._ctl] + self._slabs:
            try:
                seg.close()
            except Exception:  # noqa: BLE001
                pass
        if self.owns:
            for seg in [self._ctl] + self._slabs:
                try:
                    seg.unlink()
                except Exception:  # noqa: BLE001
                    pass
        self._slabs = []
