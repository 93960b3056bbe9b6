"""Multi-tenant continuous learning (counterpart of
`deeplearning4j_tpu/tenancy/`): LoRA adapter deltas over a shared base
model, trained, published and swapped per tenant.

`lora` owns the adapter math and `LoRAWeight`; `fleet` owns
`TenantFleet`, the shared-base serving host. The publish unit is the
adapter tree alone (`ModelRegistry.publish_adapter` / `resolve_adapter`
in `serving/registry.py`).
"""

from deeplearning4j_tpu_torch.tenancy.lora import (  # noqa: F401
    LoRAWeight, adapter_weight_keys, init_adapter, attach_adapter,
    extract_adapter, strip_adapter, compose_params, adapter_bytes,
    save_adapter, load_adapter, contains_lora,
)
from deeplearning4j_tpu_torch.tenancy.fleet import TenantFleet  # noqa: F401
