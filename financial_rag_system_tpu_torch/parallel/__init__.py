from financial_rag_system_tpu_torch.parallel.mesh import (
    AXIS_CORPUS,
    AXIS_DATA,
    create_mesh,
    local_mesh,
)
