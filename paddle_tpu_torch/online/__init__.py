"""paddle_tpu_torch.online — the online learning loop on torch (docs/online.md;
the JAX package's online/, its names and files).

Streaming training that continuously feeds the serving fleet:

- OnlineTrainer (trainer.py): the elastic Supervisor over an unbounded batch
  stream, publishing the serve set every publish_interval steps;
- ModelPublisher (publisher.py): atomic base/delta versions + LATEST.json
  pointer into a model-repository directory;
- HotReloader (reloader.py): applies new versions to live
  ServingEngine/GenerationEngine param buffers — no recompile, no dropped
  requests;
- StalenessContract (staleness.py): publisher stamps, consumer acks, and the
  publish throttle bounding how far the fleet may trail the stream.
"""

from .publisher import LATEST, ModelPublisher, read_latest
from .reloader import HotReloader
from .staleness import (
    StalenessContract,
    behind_steps,
    read_acks,
    stamp,
    write_ack,
)
from .trainer import OnlineTrainer

__all__ = [
    "OnlineTrainer",
    "ModelPublisher",
    "HotReloader",
    "StalenessContract",
    "read_latest",
    "LATEST",
    "stamp",
    "write_ack",
    "read_acks",
    "behind_steps",
]
