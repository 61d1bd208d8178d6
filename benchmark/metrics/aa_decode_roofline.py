"""The palette decode's share of its byte bound over the traced window: its
bytes a call (``aa_decode_bytes.nbytes``: each u8 index read once, its
packed-RGBA word written once) times the calls, the program's ``aa.decode``
spans wholly inside the window, at the card's peak bandwidth, over the
time of the decode's kernel records.  The decode is two library kernels a
piece of the frames (``Session._rgba_screen``), :data:`KERNELS` by name as
an H100's trace shows them under torch 2.11: the indices' copy to int32
(``direct_copy_kernel_cuda``) and the table's ``index_select``, which runs
as a gather (``_scatter_gather_elementwise_kernel``).  None without the
span (a program without it) or without a record (the CPU)."""

from benchmark.rooflines import share_of_bound

SPAN = "aa.decode"
KERNELS = ("direct_copy_kernel_cuda", "_scatter_gather_elementwise_kernel")


def read(run):
    t = run.trace
    if t is None or "aa_decode_bytes" not in run.facts:
        return None
    a, b = t.window
    calls = sum(s.name == SPAN and a <= s.start and s.end <= b for s in t.spans)
    recs = [r for needle in KERNELS for r in t.kernels(needle)]
    return share_of_bound(run.facts["aa_decode_bytes"], calls, sum(r.end - r.start for r in recs))
