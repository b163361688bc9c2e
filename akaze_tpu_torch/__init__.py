"""PyTorch/CUDA port of akaze_tpu: batched AKAZE detect + describe and
Hamming matching on an NVIDIA Hopper GPU.

Entry points: `akaze_tpu_torch.frontend.pipeline.extract_batch` and
`akaze_tpu_torch.matching.hamming.match`.  They run on "cuda" unless the
caller passes device="cpu", in which case every kernel is replaced by its
plain PyTorch twin.
"""
