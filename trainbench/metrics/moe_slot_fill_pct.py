"""Share of the expert products' capacity rows that hold a routed (token,
choice) pair: the program's ``moe.slots.kept`` over ``moe.slots.rows``
(``repro_torch.spans``), counted while a profiler ran in this process.
None where the program keeps no such counter or ran no MoE layer."""

UNIT = "%"


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    got = spans.read()
    if not got.get("moe.slots.rows"):
        return None
    return 100.0 * got["moe.slots.kept"] / got["moe.slots.rows"]
