"""Operations and bytes of one op a call, one module an op
(``perfbench/counts/<op>.py``), each exposing ``count(*args, **kwargs) ->
(flops, bytes, peak flops/s)`` on the arguments the program's function
takes.  Each input byte is read once and each output byte written once; the
operations are those the inputs need, whatever implements them."""
