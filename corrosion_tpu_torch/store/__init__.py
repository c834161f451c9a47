"""CRDT storage: schema engine, sqlite-backed store, version bookkeeping.

The port's copy of `corrosion_tpu/store/__init__.py`.
"""

from corrosion_tpu_torch.store.bookkeeping import (
    PartialVersion,
    BookedVersions,
    VersionsSnapshot,
    Booked,
    Bookie,
)

__all__ = [
    "PartialVersion",
    "BookedVersions",
    "VersionsSnapshot",
    "Booked",
    "Bookie",
]
