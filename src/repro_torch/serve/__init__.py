"""Serving tier of the port: engine, scheduler, paging, sampling, ledger."""
