"""decode.parse_share: 100 x the host wall inside
Receiver.process_step_outputs and Receiver.process_frame_bits (the FIC
and superframe, RS, AU CRC, PAD and MOT parsers, and the host leg's own
FEC) / the wall of the passes, over the traced run's passes; the harness
wraps the two methods in the traced run only."""


def read(r):
    if not r.get("pass_s") or r.get("parse_s") is None:
        return None
    return 100.0 * r["parse_s"] / sum(r["pass_s"])
