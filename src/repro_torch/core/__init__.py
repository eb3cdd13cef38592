"""DP core of the port.  This slice carries only the accountant the
serving ledger needs; ``DPContext``, the sites, norms and algos come with
the training slice."""
