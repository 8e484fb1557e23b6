from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.comm.comm import (
    all_gather,
    all_gather_into_tensor,
    all_gather_object,
    all_reduce,
    all_to_all_single,
    barrier,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    new_group,
)
