"""``relay_step_roofline``: the least time of the traced calls' relay
work over the relay step's device time in the trace, in %.

The work is counted from the chunks, not from the kernel: each live
lane (``u`` of a digest chunk's record) needs its word read, its count
written and its state row read and written
(``lib/roofline.py:relay_step_bytes``), at the card's memory bandwidth.
The time is that of the kernels the launch counter ``relay_step`` names
(``tb_relay_kernel``, ``sw_relay_kernel``) in the traced part.  Nothing
is read where a traced relay chunk ran in another mode (``bits``,
``split``), whose work this count does not describe, or where no relay
kernel ran."""

from benchmark.lib import roofline

RELAY_PATHS = ("relay", "relay_sharded")


def read(run):
    tr, recs = run.window.trace, run.window.traced_records
    if run.kind != "stream" or not tr or not recs:
        return None
    relay = [r for r in recs if r.get("path") in RELAY_PATHS]
    kernel_s = tr["kernel_us"].get("relay_step", 0.0) / 1e6
    if not relay or kernel_s <= 0 or any(r.get("mode") != "digest"
                                         for r in relay):
        return None
    nbytes = sum(roofline.relay_step_bytes(r["u"], run.algo)
                 for r in relay)
    return 100.0 * roofline.bound_s(nbytes) / kernel_s
