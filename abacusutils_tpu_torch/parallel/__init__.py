"""The multi-GPU path on ``torch.distributed`` (the counterpart of
abacusutils_tpu/parallel): one process a GPU, a 1-D ``DeviceMesh`` over the
world, NCCL on the card and gloo for CPU ranks. See :mod:`.mesh` and
:mod:`.fft`."""
