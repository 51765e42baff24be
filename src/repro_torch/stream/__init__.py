"""Port of ``repro.stream``: so far only the cross-segment stitcher of the
segmented build (``stitch.py``).  The mutable index, delta segment and merged
search wait for ROADMAP Queue 1 item 10."""
from repro_torch.stream.stitch import StitchResult, stitch_segments

__all__ = ["StitchResult", "stitch_segments"]
