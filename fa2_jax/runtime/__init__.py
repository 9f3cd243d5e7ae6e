from fa2_jax.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_jax.runtime.sampling import SamplingParams
from fa2_jax.runtime.serving import Engine, Request, EngineStats
from fa2_jax.runtime.speculative import SpeculativeDecoder

__all__ = ["KVCacheConfig", "init_cache", "write_kv", "Engine", "Request", "EngineStats", "SamplingParams", "SpeculativeDecoder"]
