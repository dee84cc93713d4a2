"""temporal_share.<cell>: the share (%) of the frames of video inference
(the program's counter "bev#frames") that carried the previous frame's
BEV into the temporal self-attention ("bev#prev_bev_frames"; traced
run): all but each scene's first frame."""

from verbench.program_spans import counter


def read(run):
    frames = counter("bev#frames")
    if not frames:
        return None
    return 100.0 * (counter("bev#prev_bev_frames") or 0.0) / frames
