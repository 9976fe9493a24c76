"""INT8 post-training quantization (§4.7): W8A8 linear, SmoothQuant,
GPTQ and the INT8 KV cache. The W8A8 linear and the KV-cache rows run
the quant-dispatch and INT8-matmul kernels on the card."""
from repro_torch.quant.int8 import (QTensor, int8_matmul_ref,
                                    quantization_error,
                                    quantize_act_tokenwise,
                                    quantize_weight_channelwise,
                                    quantized_linear)
from repro_torch.quant.smoothquant import (apply_smoothing,
                                           calibrate_act_amax,
                                           smooth_quant_pair,
                                           smoothing_scales)
from repro_torch.quant.gptq import (calibrate_moe, gptq_quantize,
                                    hessian_from_calibration)
from repro_torch.quant.kvcache_quant import (dequantize_gqa_cache,
                                             dequantize_mla_cache,
                                             int8_attention_scores,
                                             memory_saving,
                                             quantize_gqa_cache,
                                             quantize_mla_cache)
