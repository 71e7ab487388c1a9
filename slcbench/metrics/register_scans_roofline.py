"""The registration's share of its roofline: the least time the card could
take for the ``fusion_frontend.register_scans`` calls of the traced
window (the bytes each call must move over the card's published memory
rate) as a share of the device's busy time inside the harness's
``fuse.register`` spans: their synchronised wall time less the idle
device time the trace gives them. It reads the same work whatever
kernels implement the registration.

Bytes a call, for S views of G grid points each (L = S G landmarks),
``rounds`` associations and one more for the anchor gauge, and
``rounds * gn_iters`` point-to-plane steps:

- each association writes the observations and their mask, 16 B a
  scan-landmark pair (12 + 4), and the landmarks and normals, 24 B a
  landmark;
- each step reads them again.
"""


def call_bytes(config: dict) -> int:
    s, f = config["system"], config["fusion"]
    step = int(f["grid_step"])
    views = int(f["views"])
    landmarks = views * (s["cam_h"] // step) * (s["cam_w"] // step)
    once = 16 * views * landmarks + 24 * landmarks
    passes = (int(f["rounds"]) + bool(f["anchor_gauge"])
              + int(f["rounds"]) * int(f["gn_iters"]))
    return passes * once


def read(run):
    t = run.spans.get("fuse.register")
    tr = run.trace
    if not t or tr is None or not tr.saw_device \
            or run.hbm_bytes_per_s is None:
        return None
    busy = sum(t) - tr.idle_by_span.get("fuse.register", 0.0)
    if busy <= 0:
        return None
    return 100.0 * len(t) * call_bytes(run.config) / run.hbm_bytes_per_s \
        / busy
