"""PyTorch/CUDA port of the Farview reproduction.

A second package beside the JAX reference `repro`, mirroring it module for
module (`repro_torch.core.client` <-> `repro.core.client`, ...). It imports
torch and numpy only — never jax, never anything of `repro`. Entry points
run on the CUDA card unless the caller passes `device="cpu"`; on the card
every kernel on the request path is a hand-written CUDA kernel
(`kernels/csrc/`), on the CPU its plain torch version runs instead.

The verb API re-exported here covers the ported slices: selection,
projection, smart addressing and CTR crypt (rows kind), the small-table
join `JoinSmall` (rows kind, its build table read from the node's pool at
every dispatch), GroupBy and Distinct (groups kind, merged client-side by
`merge_group_partials`), over word tables of any width; and RegexMatch
(mask kind) over string tables (`string_table`), whose bytes ride each
request as `strings=` / `lengths=`. Tables demote to the pool's compressed
cold tier (`node.pool.demote_table`) and every verb runs over them
unchanged, their cold pages decoded on the device in the dispatch.
"""
from repro_torch.core.client import (FViewNode, PendingRequest, QPair,
                                     alloc_table_mem, close_connection,
                                     farview_request, free_table_mem,
                                     load_node_state, merge_group_partials,
                                     open_connection, submit_request,
                                     table_read, table_read_rows,
                                     table_write)
from repro_torch.core.errors import (DeadlineExceededError, FarviewError,
                                     NodeDeadError, PageCodecError)
from repro_torch.core.pipeline import PipelineResult, compile_pipeline
from repro_torch.core.table import Column, FTable, string_table
