from smmb_tpu_torch.bench.flops import dense_flops, sparse_flops, spmm_bytes
from smmb_tpu_torch.bench.measure import Measurement, measure
from smmb_tpu_torch.bench.roofline import ChipSpec, chip_spec, roofline_bound
