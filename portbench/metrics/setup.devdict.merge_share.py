"""The device dictionary builder's merges (its `devdict.merge` spans: the
card's seconds between their events, the host's where they have none, on
the CPU), summed over the set-up's build, as a share of `setup_s` (%).
Read from the build's recording (builders/device_dict.LAST); None where
there is none, or where the program records no such span."""


def read(ctx):
    from portbench.builders import device_dict

    last = device_dict.LAST
    if ctx.kind != "anchor" or last is None:
        return None
    s = last["totals"]["spans"].get("devdict.merge")
    if s is None:
        return None
    seconds = s["device_s"] if s["device_s"] is not None else s["host_s"]
    return 100.0 * seconds / ctx.setup_s
