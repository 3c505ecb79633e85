from repro_torch.distributed.collectives import (compressed_psum,
                                                 dequantize_int8,
                                                 psum_scatter_matmul,
                                                 quantize_int8)
from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                              ShardingRules)
