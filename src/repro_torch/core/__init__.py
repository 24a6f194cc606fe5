from repro_torch.core.policy import (ExecutionPolicy, default_policy,  # noqa: F401
                                     get_kernel, list_named_policies,
                                     named_policy, register_kernel)
