"""The share of the exchanged bytes that are valid rows: the program's
counters ``exchange.valid_bytes.l*`` (slots whose ``slot_to_tilde >= 0``)
over ``exchange.slot_bytes.l*`` (every slot of the padded buffers, a row of
the layer's width a slot), summed over the layers and every run of the
step program, from its ``report()``, in percent."""


def read(ctx):
    valid = slots = 0
    for rep in ctx["program_report"].values():
        for name, v in rep.get("counters", {}).items():
            if name.startswith("exchange.valid_bytes."):
                valid += v
            elif name.startswith("exchange.slot_bytes."):
                slots += v
    return 100.0 * valid / slots if slots else None
