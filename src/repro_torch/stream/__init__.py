"""Port of ``repro.stream``: the streaming mutable index and the
cross-segment stitcher of the segmented build.

  * ``delta``    — append-only host segment with an incrementally
                   maintained Vamana graph (greedy search + robust prune per
                   insert, reverse-edge patching), numpy as in the reference;
  * ``mutable``  — MutableIndex: base index + delta segment + tombstones,
                   with ``consolidate()`` rebuilding the base on its device;
  * ``searcher`` — merged search: the base search on the device + the delta
                   search on the host, fused by accurate distance with
                   tombstone filtering in one sort launch;
  * ``stitch``   — the segmented build's cross-segment stitcher.
"""
from repro_torch.stream.delta import DeltaSegment
from repro_torch.stream.mutable import MutableIndex
from repro_torch.stream.searcher import (
    MergedResult, merged_search_kernel, search_merged,
)
from repro_torch.stream.stitch import StitchResult, stitch_segments

__all__ = ["DeltaSegment", "MutableIndex", "MergedResult",
           "merged_search_kernel", "search_merged",
           "StitchResult", "stitch_segments"]
