"""% of the device time inside the fused segments' spans in which two or
more device operations ran at once: the co-execution split's overlap
where it runs, over the union of the device operations clipped to the
`repro_torch.segment[<k>] fused` spans of the traced walks."""
from portbench import spans


def read(run):
    if not spans.walks(run):
        return None
    fused = spans.named(run.trace, spans.FUSED_SEGMENT.match)
    return spans.overlap_share(run.trace, fused) if fused else None
