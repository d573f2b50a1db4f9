"""Measurement tools of the port, each a twin of a JAX tool in ``tools/``
with its flags and its printed JSON line (or markdown table), run as
``python -m nvae_torch.tools.<name>``: on the card unless given ``--cpu``
(asking for the card where there is none raises), with a ``--quick``
debug-size form.

- ``profile_step``: ``capture`` a ``torch.profiler`` trace of training
  steps (or one graph replay of the scan path), ``analyze`` it: device time
  per kernel and per category, busy against wall time, the step's parts,
  the longest idle gaps;
- ``memory_report``: state bytes per rank in the ``single``,
  ``replicated`` and ``fsdp`` layouts, and the step's working set;
- ``parity_run``: a training run with held-out ELBO and IWAE NLL curves;
- ``bench_eval_protocol``: the wall time of one full evaluation protocol;
- ``reproduce_baseline``: train, run both evaluation protocols, print the
  table against BASELINE.md;
- ``bench_serving_runtime``, ``bench_serving_http``: the batching server
  under closed, Poisson and HTTP loads;
- ``bench_async_ckpt``: epochs without, with blocking and with background
  checkpoints;
- ``bench_serving_artifact``: artifact bytes and img/s, bf16 against int8.
"""
