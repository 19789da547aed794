"""The SFL-GA training benchmark's harness (see ``sflbench/README.md``)."""
