"""The card's counterparts of the JAX package's twelve Pallas probes.

Each module mirrors one file of ``tools/`` (which stays as it is): the same
function names, keyword sizes and ``PROBES`` dict, plus ``device=None``
(the card; the CPU only when asked). For every probe one function returns
its output and ``probe_<name>`` times it on the card. Run one file's probes
on the card with

    python -m elasticdeform_tpu_torch.probes.probe_pallas [names...]
    python -m elasticdeform_tpu_torch.probes.probe_gather [names...]
    python -m elasticdeform_tpu_torch.probes.probe_gather2 [names...]
    python -m elasticdeform_tpu_torch.probes.probe_dyngather2

The kernels, P1-P4, are in ``csrc/probes.cu`` and their wrappers in
:mod:`elasticdeform_tpu_torch.ops.probes`.
"""
