"""The rows the device dictionary builder's merges sorted (its
`devdict.merged_rows` counter, live rows plus new a merge) over the
finished dictionary's keys: how many times the build re-sorts each key.
Read from the build's recording (builders/device_dict.LAST); None where
there is none, or where the program counts no such rows."""


def read(ctx):
    from portbench.builders import device_dict

    last = device_dict.LAST
    if ctx.kind != "anchor" or last is None or not last["keys"]:
        return None
    rows = last["totals"]["counters"].get("devdict.merged_rows")
    if rows is None:
        return None
    return rows / last["keys"]
