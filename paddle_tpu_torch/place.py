"""Places (reference paddle/fluid/platform/place.h:26-99 — CPUPlace,
CUDAPlace, CUDAPinnedPlace). Here a place names a torch.device; pinned host
memory is a CPU place, as in the JAX package. Entry points take the card
unless the caller passes CPUPlace() explicitly: with no place and no CUDA
device, to_device() raises instead of carrying on on the CPU."""

import torch

__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "is_compiled_with_cuda", "to_device"]


class Place:
    def __eq__(self, other):
        return type(self) is type(other) and getattr(self, "device_id", 0) == getattr(
            other, "device_id", 0
        )

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "device_id", 0)))


class CPUPlace(Place):
    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r: no CUDA device is available; pass CPUPlace() to run on "
                "the CPU" % self
            )
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: the CPU (the data layer stages through
    pinned buffers of its own whatever the place)."""

    def __repr__(self):
        return "CUDAPinnedPlace"


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def to_device(place=None):
    """torch.device for a place (a Place, a torch.device, a device string, or
    None for CUDAPlace(0))."""
    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, Place):
        return place.torch_device()
    dev = torch.device(place)
    if dev.type == "cuda":
        return CUDAPlace(0 if dev.index is None else dev.index).torch_device()
    return dev
