"""The safety filters (port of the JAX package's ``safety``): the
double integrator's exponential CBF, the air taxi's HJ filter and ORCA."""
from .cbf import cbf_qp_analytic, di_exp_cbf_filter
from .hj import HjValueData, airtaxi_hj_filter, make_synthetic_airtaxi_hj

__all__ = [
    "cbf_qp_analytic",
    "di_exp_cbf_filter",
    "HjValueData",
    "airtaxi_hj_filter",
    "make_synthetic_airtaxi_hj",
]
