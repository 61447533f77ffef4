"""python -m witch_tpu_torch -b backbone -e tree -q queries -d outdir -o out
python -m witch_tpu_torch serve|submit ...   (server.py)"""

import sys

from . import witch_runner

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("serve", "submit"):
        from .server import main
        raise SystemExit(main(sys.argv[1:]))
    witch_runner()
