"""repro_torch.data — the synthetic and memory-mapped token streams (a
copy of repro.data: numpy only, so both packages draw identical batches)."""
from repro_torch.data.pipeline import (  # noqa: F401
    MMapTokens, MarkovLM, ShardedLoader, write_token_file,
)
