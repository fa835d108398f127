"""The work a kernel's inputs need, whatever implements it: operations
and bytes computed from shapes, frozen here so that a later kernel doing
the same work another way is judged on the same yardstick."""
