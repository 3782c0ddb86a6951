"""The device dictionary builder's chunk staging, upload and packing (its
`devdict.pack` spans, host clock), summed over the set-up's build, as a
share of `setup_s` (%).  Read from the build's recording
(builders/device_dict.LAST); None where there is none, or where the
program records no such span."""


def read(ctx):
    from portbench.builders import device_dict

    last = device_dict.LAST
    if ctx.kind != "anchor" or last is None:
        return None
    s = last["totals"]["spans"].get("devdict.pack")
    if s is None:
        return None
    return 100.0 * s["host_s"] / ctx.setup_s
