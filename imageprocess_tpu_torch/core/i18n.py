"""Message catalogs (ko / en) and the ``t()`` lookup (the port's copy).

Korean is the default, as in the reference toolkit; ``t(key)`` falls back
to a given default, then to the English entry, then to the key itself.
``pick_lang_from_argv`` reads the command line's ``-mode`` / ``--lang`` and
``set_lang`` switches the current language.
"""

from __future__ import annotations

from typing import Optional, Sequence

DEFAULT_LANG = "ko"
LANG_CURRENT = DEFAULT_LANG

STRINGS = {
    "ko": {
        "app_title": "ImageProcess TPU — 형광 이미지 정량 분석",
        "run_start": "================= 실행 시작 =================",
        "run_end": "================= 실행 종료 =================",
        "log_no_ch": "[스킵] {stid} — 채널 없음",
        "log_no_roi": "[스킵] {stid} — ROI 없음",
        # stays English even in ko — the reference's Korean golden run log
        # carries the literal tag (Testsamples/.../run_20251122_122406.txt:7)
        "log_done_quant": "[DONE-QUANT] {stid} ROI={roi_count}",
        "log_save_xls": "[저장 완료] {path}",
        "msg_no_pairs": "매칭되는 (donor, fret) 채널 쌍이 없습니다.",
        "msg_info_pairs": "[정보] 총 처리 대상 쌍: {count}",
        "msg_processing": "[처리] {tag} ...",
        "msg_warn_no_roi_tag": "[경고] {tag}: ROI 없음 — 건너뜀",
        "msg_done_outdir": "[완료] 출력 폴더: {dir}",
        "warn_no_map": "[스킵] 채널 ch={ch}에 해당하는 파일을 찾지 못했습니다.",
        "done_all": "[완료] 모든 크롭 작업 완료.",
        "auto_found": "[자동분할] {tag}: ROI {count}개",
        "auto_read_failed": "  [읽기 실패] {name}: {err}",
        "auto_blank_skip": "  [스킵] 빈 이미지: {name}",
        "auto_seg_failed": "  [분할 에러] {name}: {err}",
        "ppt_done": "FRET_timelapse_auto.pptx 생성 완료",
        "ppt_no_pairs": "유효한 FRET/BF 페어가 없습니다.",
        "progress": "[진행] {done}/{total}",
        "elapsed": "[소요] {mm:02d}:{ss:02d}",
        # shared pipeline events
        "err_worker": "[오류][작업] {key}: {error}",
        "cancelled": "[취소됨]",
        "saved_dir": "[저장 완료] {dir}",
        "subset_no_match": "[부분집합] 스테이지 {stage}에 해당하는 파일이 없습니다",
        "batch_progress": "[배치] {done} 프레임",
        "compile_note": "[안내] 첫 디스패치에서 배치 프로그램을 컴파일했습니다"
                        " ({sec:.0f}초) — 이후 실행은 캐시를 사용합니다",
        # crop (roi_channel_cropper)
        "crop_no_channel": "[스킵] 채널 ch={ch} 파일 없음",
        "crop_subset_no_match": "[부분집합] 일치 항목 없음",
        "crop_no_roi": "[스킵] ROI 없음 {tag}",
        "crop_subset_warn": "[부분집합 경고] {tag}: ROI 없음 {k}",
        "crop_warn_too_large": "[경고] {tag}: 크롭이 프레임보다 큼 — 잘라냄",
        "crop_warn_norm": "[경고] 정규화 실패: {tag}",
        # FA analyzer
        "fa_export": "[내보내기] {tag}: 세포 {count}개",
        "fa_fig": "[그림] {path}",
        "fa_processing": "{tag} 처리 중...",
        "fa_load_failed": "  [에러] 이미지 로드 실패: {tag} ({err})",
        # FRET tables
        "fret_saved": "[저장 완료] xls/fret_ratio_perROI.xlsx + csv",
        "fret_no_roi": "[경고] ROI 없음 -> 지표 테이블을 생성하지 않음.",
        "fret_no_pairs": "donor=_{donor}, acceptor=_{acceptor} 에 해당하는 파일 쌍이 없습니다.",
        "fret_roi_missing": "    [경고] ROI 없음: {tag}.json -> ROI 기반 출력을 건너뜀",
        # morphology
        "mor_info_files": "[정보] 파일: {total} | 사용: {used} | {extra}",
        "mor_skip_parse": "[스킵] 스테이지 파싱 실패: {base}",
        "mor_no_roi": "[경고] ROI를 찾지 못함: {tag}.json",
        "mor_no_results": "[경고] 결과 없음",
        "mor_saved": "[저장 완료] {path}",
        # annotator / tuner apps
        "draw_task": "[작업] {base}: 채널 {channels}",
        "tune_saved": "[저장 완료] {path}",
        "tune_tag": "[튜닝] {tag}",
        "tune_mat": "[MATLAB 경계] {path}: {count}개",
        # drawer save bundle + annotator events
        "drawer_json_saved": "  JSON 저장: {path}",
        "drawer_mask_saved": "  마스크 저장: {path}",
        "drawer_overlay_saved": "  오버레이 저장: {path}",
        "drawer_zip_saved": "  zip 저장: {path}",
        "drawer_mask_failed": "  [경고] 마스크 저장 실패: {err}",
        "drawer_overlay_failed": "  [경고] 오버레이 저장 실패: {err}",
        "drawer_zip_failed": "  [경고] ImageJ ROI ZIP 저장 실패: {err}",
        "draw_resumed": "  {count}개 ROI 재개: {path}",
        "draw_roi_added": "  ROI {n}: thr={thr}, {kind} ({nv} 정점)",
        "draw_kind_auto": "자동",
        "draw_kind_rough": "러프",
        "draw_roi_redrawn": "  ROI {i} 다시 그림 ({nv} 정점)",
        "n2_images_serial": "[안내] 이미지 출력이 켜져 있어 쌍별 직렬 러너로 진행합니다",
        "int_images_serial": "[안내] 이미지 출력/배경 범위 설정으로 직렬 러너로 진행합니다 (메시 미사용)",
        "cli_experiment": "=== 실험: {folder}",
        "cli_devices_error": "[오류] --devices {n} > 사용 가능 장치 {avail}개",
    },
    "en": {
        "app_title": "ImageProcess TPU — fluorescence image quantification",
        "run_start": "================= Run start =================",
        "run_end": "================= Run end =================",
        "log_no_ch": "[SKIP] {stid} — no channels",
        "log_no_roi": "[SKIP] {stid} — no ROI",
        "log_done_quant": "[DONE-QUANT] {stid} ROI={roi_count}",
        "log_save_xls": "[Saved] {path}",
        "msg_no_pairs": "No matched (donor, fret) channel pairs.",
        "msg_info_pairs": "[Info] pairs to process: {count}",
        "msg_processing": "[Processing] {tag} ...",
        "msg_warn_no_roi_tag": "[Warn] {tag}: no ROI — skipped",
        "msg_done_outdir": "[Done] output folder: {dir}",
        "warn_no_map": "[SKIP] no files for channel ch={ch}.",
        "done_all": "[Done] all crops complete.",
        "auto_found": "[auto-seg] {tag}: {count} ROIs",
        "auto_read_failed": "  [read failed] {name}: {err}",
        "auto_blank_skip": "  [skip] blank image: {name}",
        "auto_seg_failed": "  [segmentation error] {name}: {err}",
        "ppt_done": "FRET_timelapse_auto.pptx created",
        "ppt_no_pairs": "No valid FRET/BF pairs.",
        "progress": "[Progress] {done}/{total}",
        "elapsed": "[Elapsed] {mm:02d}:{ss:02d}",
        # shared pipeline events
        "err_worker": "[ERROR][WORKER] {key}: {error}",
        "cancelled": "[CANCELLED]",
        "saved_dir": "[SAVED] {dir}",
        "subset_no_match": "[subset] no files match stage={stage}",
        "batch_progress": "[batch] {done} frames",
        "compile_note": "[note] first dispatch compiled the batch program"
                        " ({sec:.0f}s) — cached for subsequent runs",
        # crop (roi_channel_cropper)
        "crop_no_channel": "[skip] no files for channel ch={ch}",
        "crop_subset_no_match": "[subset] no match",
        "crop_no_roi": "[skip] no ROI {tag}",
        "crop_subset_warn": "[subset warn] {tag}: no ROI {k}",
        "crop_warn_too_large": "[warn] {tag}: crop larger than frame side, clipping",
        "crop_warn_norm": "[warn] normalization failed: {tag}",
        # FA analyzer
        "fa_export": "[export] {tag}: {count} cells",
        "fa_fig": "[fig] {path}",
        "fa_processing": "Processing {tag}...",
        "fa_load_failed": "  [Error] Failed to load image: {tag} ({err})",
        # FRET tables
        "fret_saved": "[Saved] xls/fret_ratio_perROI.xlsx + csv",
        "fret_no_roi": "[Warn] No ROI -> metric table not generated.",
        "fret_no_pairs": "No matched files for donor=_{donor}, acceptor=_{acceptor}.",
        "fret_roi_missing": "    [Warn] ROI missing: {tag}.json -> skip ROI-based outputs",
        # morphology
        "mor_info_files": "[info] files: {total} | used: {used} | {extra}",
        "mor_skip_parse": "[skip] stage parse failed: {base}",
        "mor_no_roi": "[warn] ROI not found: {tag}.json",
        "mor_no_results": "[warn] no results",
        "mor_saved": "[saved] {path}",
        # annotator / tuner apps
        "draw_task": "[task] {base}: channels {channels}",
        "tune_saved": "[saved] {path}",
        "tune_tag": "[tune] {tag}",
        "tune_mat": "[MATLAB boundaries] {path}: {count}",
        # drawer save bundle + annotator events
        "drawer_json_saved": "  JSON saved: {path}",
        "drawer_mask_saved": "  mask saved: {path}",
        "drawer_overlay_saved": "  overlay saved: {path}",
        "drawer_zip_saved": "  zip saved: {path}",
        "drawer_mask_failed": "  [warn] mask save failed: {err}",
        "drawer_overlay_failed": "  [warn] overlay save failed: {err}",
        "drawer_zip_failed": "  [warn] ImageJ ROI zip save failed: {err}",
        "draw_resumed": "  resumed {count} ROIs from {path}",
        "draw_roi_added": "  ROI {n}: thr={thr}, {kind} ({nv} vertices)",
        "draw_kind_auto": "auto",
        "draw_kind_rough": "rough",
        "draw_roi_redrawn": "  ROI {i} redrawn ({nv} vertices)",
        "n2_images_serial": "[note] image outputs requested — using the per-pair serial runner",
        "int_images_serial": "[note] image outputs / bg scope need the serial runner — mesh not used",
        "cli_experiment": "=== experiment: {folder}",
        "cli_devices_error": "[error] --devices {n} > {avail} available",
    },
}


def t(key: str, default: Optional[str] = None, lang: Optional[str] = None) -> str:
    """Reference-style lookup: catalog[lang][key], falling back to the
    provided default, then the key itself."""
    lang = (lang or LANG_CURRENT).lower()
    table = STRINGS.get(lang, STRINGS[DEFAULT_LANG])
    if key in table:
        return table[key]
    if default is not None:
        return default
    return STRINGS["en"].get(key, key)


def pick_lang_from_argv(argv: Sequence[str]) -> str:
    """``-mode EN`` / ``-mode KO`` (the reference's flag) and
    ``--lang en|ko``.  Unknown values keep the default."""
    lang = DEFAULT_LANG
    args = list(argv)
    for i, a in enumerate(args):
        if a == "-mode" and i + 1 < len(args):
            v = args[i + 1].lower()
            if v in STRINGS:
                lang = v
        elif a.startswith("--lang"):
            v = a.split("=", 1)[1] if "=" in a else (
                args[i + 1] if i + 1 < len(args) else "")
            if v.lower() in STRINGS:
                lang = v.lower()
    return lang


def set_lang(lang: str) -> None:
    global LANG_CURRENT
    if lang.lower() in STRINGS:
        LANG_CURRENT = lang.lower()
