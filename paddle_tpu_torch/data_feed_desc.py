"""DataFeedDesc: declarative description of a multi-slot data feed.

Reference analog: python/paddle/fluid/data_feed_desc.py wrapping the
framework/data_feed.proto textproto (MultiSlotDataFeedDesc: per-slot name,
type, is_dense, is_used; batch_size). The same textproto surface is accepted
here — parsed with a small text-format reader instead of protobuf — and
lowered to the native MultiSlotDataFeed's slot-type vector
(paddle_tpu_torch/native, C++ parser threads).
"""

import re

__all__ = ["DataFeedDesc"]


class _Slot:
    def __init__(self):
        self.name = None
        self.type = "uint64"  # reference types: uint64 | float
        self.is_dense = False
        self.is_used = False
        self.dense_dim = 1


class DataFeedDesc:
    def __init__(self, proto_text_or_path):
        try:
            with open(proto_text_or_path) as f:
                text = f.read()
        except (OSError, ValueError):
            text = proto_text_or_path
        self.name = "MultiSlotDataFeed"
        self.batch_size = 32
        self.slots = []
        self._parse(text)
        self._slot_by_name = {s.name: s for s in self.slots}

    def _parse(self, text):
        # minimal textproto reader for the data_feed.proto schema:
        # name/batch_size at top level, slots{...} blocks under multi_slot_desc
        m = re.search(r'name\s*:\s*"([^"]+)"', text)
        if m:
            self.name = m.group(1)
        m = re.search(r"batch_size\s*:\s*(\d+)", text)
        if m:
            self.batch_size = int(m.group(1))
        for block in re.findall(r"slots\s*\{([^}]*)\}", text):
            s = _Slot()
            m = re.search(r'name\s*:\s*"([^"]+)"', block)
            if m:
                s.name = m.group(1)
            m = re.search(r'type\s*:\s*"([^"]+)"', block)
            if m:
                s.type = m.group(1)
            m = re.search(r"is_dense\s*:\s*(\w+)", block)
            if m:
                s.is_dense = m.group(1) in ("true", "True", "1")
            m = re.search(r"is_used\s*:\s*(\w+)", block)
            if m:
                s.is_used = m.group(1) in ("true", "True", "1")
            self.slots.append(s)

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_use_slots(self, use_slots_name):
        for name in use_slots_name:
            self._slot_by_name[name].is_used = True

    def set_dense_slots(self, dense_slots_name):
        for name in dense_slots_name:
            self._slot_by_name[name].is_dense = True

    def native_slot_types(self):
        """Per-slot dtype codes for the native parser (file column order)."""
        from . import native

        return [
            native.FLOAT32_SLOT if s.type == "float" else native.INT64_SLOT
            for s in self.slots
        ]

    def used_slots(self):
        return [(i, s) for i, s in enumerate(self.slots) if s.is_used]

    def desc(self):
        lines = ['name: "%s"' % self.name, "batch_size: %d" % self.batch_size]
        lines.append("multi_slot_desc {")
        for s in self.slots:
            lines.append(
                '  slots {\n    name: "%s"\n    type: "%s"\n    is_dense: %s\n    is_used: %s\n  }'
                % (s.name, s.type, str(s.is_dense).lower(), str(s.is_used).lower())
            )
        lines.append("}")
        return "\n".join(lines)
