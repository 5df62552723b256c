from .context import (NNContext, ZooTpuConfig, init_nncontext,
                      initNNContext, get_nncontext, reset_nncontext,
                      check_version, resolve_device)
