"""Busy device milliseconds a step in GraphCast's encoder and decoder,
forward and backward (the embeddings, the grid->mesh and mesh->grid
interaction networks, the output MLP and the loss): the program's
sub-phases ``encoder``, ``decoder``, ``decoder_bwd`` and ``encoder_bwd``
(its stage markers, ``harness/spans.py``), over the traced window's whole
steps.  ``None`` where the program has no such markers."""

from harness import spans

STAGES = ("encoder", "decoder", "decoder_bwd", "encoder_bwd")


def read(ctx):
    parts = [spans.phase_ms(ctx, s) for s in STAGES]
    return None if None in parts else sum(parts)
