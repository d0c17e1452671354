"""Hand-written Hopper (sm_90a) kernels for the serve hot paths.

  flash_attention_fwd   causal GQA prefill attention (csrc/flash_attention.cu)
  flash_decode          one-token decode over a contiguous cache
  flash_decode_paged    one-token decode walking the paged KV pool through
                        the block table (both in csrc/flash_decode.cu)
  rwkv6_chunked         the chunked WKV6 recurrence of RWKV6 prefill
                        (csrc/rwkv6_scan.cu)
  ssd_chunked           the chunked Mamba-2 SSD of the hybrid (hymba)
                        prefill (csrc/mamba_ssd.cu)
  grouped_matmul        the expert-batched GEMMs of the MoE (granite)
                        expert FFN (csrc/moe_gmm.cu)

Each wrapper runs its plain version (kernels/ref.py) on a CPU tensor and
launches its kernel on a CUDA tensor, counting launches in LAUNCHES. Each
picks a route before the launch by its module's `_route` from dtype, shape,
strides and alignment, counted in ROUTES: grouped_matmul,
flash_attention_fwd, flash_decode and flash_decode_paged take bf16
tensor-core tiles (mma.sync / wgmma; "tc", "tc_decode", "tc_prefill") where
the operands' rows are 16-byte aligned, else f32-FMA tiles ("simt_bf16"),
and float32 always the f32-FMA tiles ("simt_f32"); rwkv6_chunked and
ssd_chunked (float32 only) take f32 register tiles fed by cp.async ("tile")
where the rows are 16-byte aligned, else the first f32-FMA design
("simt"). Nothing is compiled at import: kernels/_build.py builds at
first use.
"""
from repro_torch.kernels._build import (LAUNCHES, ROUTES, build_all,
                                        reset_launches)

__all__ = ["LAUNCHES", "ROUTES", "build_all", "reset_launches"]
