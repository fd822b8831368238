"""Chunks per block-end recompute: the counting pass's `chunk` spans of
the port (utils/chunking.py chunked_map, one per group of chains) over
its `recompute` spans (mc/gcmc_mol.py full_energy).  Nothing where the
port marks no recompute; 0 where a kernel serves the recompute with no
chunks."""


def read(ctx):
    if ctx.unit != "muvt_cycle":
        return None
    _, _, calls = ctx.spans.total("recompute", "count")
    _, _, chunks = ctx.spans.total("chunk", "count")
    return chunks / calls if calls else None
